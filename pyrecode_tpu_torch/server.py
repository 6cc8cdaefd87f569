"""ReCoDeServer on PyTorch: thread-mode nodes that write with the port's writer.

The head node, protocol, logger and recovery are the JAX package's
(:mod:`pyrecode_tpu.server`, which never imports JAX itself).  Its
``ReCoDeServer.run`` and ``_spawn_replacement_node`` create
``pyrecode_tpu.server.ReCoDeNode`` by name, so this module overrides both to
create :class:`ReCoDeNode`, whose ``_open`` builds the port's writer on the
server's device.  All nodes share the one card and launch from their own
threads.

``isolation="process"`` is not ported yet: its workers import JAX
(ROADMAP Queue 1 item 6).
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Dict, List, Optional

from pyrecode_tpu.constants import rc_cfg as rc
from pyrecode_tpu.params import InitParams, InputParams
from pyrecode_tpu.server import Logger, MessageData, NodeClient  # noqa: F401  (re-exported)
from pyrecode_tpu.server import ReCoDeNode as _JaxReCoDeNode
from pyrecode_tpu.server import ReCoDeServer as _JaxReCoDeServer

from .device import resolve_device
from .writer import ReCoDeWriter


class ReCoDeNode(_JaxReCoDeNode):
    """Thread-mode worker owning one port writer and its part file."""

    def __init__(self, *args, device="cuda", **kwargs):
        super().__init__(*args, **kwargs)
        self._device = device

    def _open(self) -> None:
        image_filename = self._init_params.image_filename
        if self._init_params.mode == "stream":
            image_filename = os.path.join(self._init_params.directory_path, "Next_Stream.seq")
        self._writer = ReCoDeWriter(
            image_filename,
            dark_data=self._dark_data,
            dark_filename=self._init_params.calibration_filename,
            output_directory=self._init_params.output_directory,
            input_params=self._input_params,
            mode=self._init_params.mode,
            validation_frame_gap=self._init_params.validation_frame_gap,
            log_filename=self._init_params.log_filename,
            run_name=self._init_params.run_name,
            verbosity=self._init_params.verbosity,
            use_tpu=self._init_params.use_tpu,
            node_id=self.node_id,
            device=self._device)
        self._log("writer created")


class ReCoDeServer(_JaxReCoDeServer):
    """Head node: orchestrates N thread-mode nodes + logger."""

    def __init__(self, mode: str = "batch", isolation: str = "thread", device="cuda"):
        if str(isolation).strip().lower() == "process":
            raise NotImplementedError(
                "isolation='process' is not ported yet (ROADMAP Queue 1 item 6)")
        self._device = resolve_device(device)
        super().__init__(mode, isolation)

    def _node(self, index: int, logger: Logger, **kwargs) -> ReCoDeNode:
        return ReCoDeNode(index, self._init_params_live, self._input_params_live, logger,
                          self._session_id, device=self._device, **kwargs)

    def run(self, init_params: InitParams, input_params: Optional[InputParams] = None,
            dark_data=None, data=None, fail_node_ids=(), fail_node_on_command=None
            ) -> Dict[int, dict]:
        """Run a full acquisition; returns per-node run metrics.

        The thread-mode body of :meth:`pyrecode_tpu.server.ReCoDeServer.run`,
        creating the port's nodes.
        """
        if input_params is None:
            input_params = InputParams()
            input_params.load(Path(init_params.params_filename))
        if not input_params.validate():
            raise ValueError("Invalid input params")

        logger = Logger(self._session_id, init_params.log_filename)
        logger.start(echo=init_params.verbosity > 0)
        logger.push("head", f"session {self._session_id} starting "
                            f"({input_params.num_threads} nodes, mode={self._mode})")

        self._log_mp_queue = None
        self._log_drainer = None
        self._init_params_live, self._input_params_live = init_params, input_params
        nodes = [
            self._node(i, logger,
                       fail_on_command=fail_node_on_command if i in fail_node_ids else None)
            for i in range(int(input_params.num_threads))
        ]
        self._nodes = nodes  # exposed for tests/monitoring
        for node in nodes:
            node.start_thread(dark_data=dark_data, data=data)
        clients = [NodeClient(node.token, self._session_id, timeout=5.0) for node in nodes]
        self._client_timeout = 5.0
        self._dark_data, self._data = dark_data, data

        try:
            self._broadcast(clients, nodes, "start", logger)
            if self._mode == "batch":
                self._broadcast(clients, nodes, "process_file", logger)
                self._wait_until_available(nodes)
                # recover nodes that died mid-processing (one retry round)
                for index, node in enumerate(nodes):
                    if node.status == rc.STATUS_CODE_ERROR:
                        self._spawn_replacement_node(index, clients, nodes, logger)
                        clients[index].send_request("process_file")
                self._wait_until_available(nodes)
            else:
                self._recode_queue_manager(clients, nodes, init_params, logger)
            self._broadcast(clients, nodes, "close", logger)
        finally:
            for node in nodes:
                node.join(timeout=30)
            logger.push("head", "session closed")
            logger.close()

        return {node.node_id: node.run_metrics for node in nodes}

    def _spawn_replacement_node(self, index: int, clients: List[NodeClient],
                                nodes: List[ReCoDeNode], logger: Logger) -> None:
        """Rebuild a failed node in place and bring it back to AVAILABLE
        (see :meth:`pyrecode_tpu.server.ReCoDeServer._spawn_replacement_node`)."""
        logger.push("head", f"spawning replacement for node-{index}",
                    rc.MESSAGE_TYPE_ERROR)
        replacement = self._node(
            index, logger, resume=self._mode == "stream",
            resume_chunk_offset=getattr(self, "_stream_chunk_offset", 0))
        replacement.start_thread(dark_data=self._dark_data, data=self._data)
        nodes[index] = replacement
        clients[index] = NodeClient(replacement.token, self._session_id,
                                    timeout=getattr(self, "_client_timeout", 5.0))
        clients[index].send_request("start")
