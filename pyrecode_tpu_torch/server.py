"""ReCoDeServer on PyTorch: the head node and thread-mode nodes on one card.

The port's counterpart of pyrecode_tpu/server.py, classes of their own with
the reference server's protocol (recode_server.py:54-773): ``run`` drives N
``ReCoDeNode`` workers and a ``Logger`` through the ack-verified command
sequence start -> process_file* -> close, with the status lifecycle
NOT_READY -> AVAILABLE -> BUSY -> ... -> IS_CLOSED, reliable broadcast with
retries, replacement of failed nodes, and a stream mode that watches a
directory for chunk files.  Nodes are threads that share the one card and
launch from their own threads; each owns the port's writer and its part
file.  The ZMQ sockets of the reference become in-process queues carrying
the same ``MessageData`` envelopes.

``isolation="process"`` is not ported yet: its workers must keep CUDA
uninitialised (ROADMAP Queue 1).
"""

from __future__ import annotations

import json
import os
import queue
import threading
import time
import traceback
from datetime import datetime
from pathlib import Path
from typing import Dict, List, Optional

from .constants import rc_cfg as rc
from .device import resolve_device
from .params import InitParams, InputParams
from .writer import ReCoDeWriter


class MessageData:
    """JSON message envelope (reference recode_server.py:54-115)."""

    def __init__(self, session_id, message_type, message, mapped_data=None):
        self._payload = {
            "session_id": session_id,
            "type": message_type,
            "message": message,
            "mapped_data": dict(mapped_data or {}),
        }
        self._payload["mapped_data"].setdefault("timestamp", datetime.now().isoformat())

    @property
    def session_id(self):
        return self._payload["session_id"]

    @property
    def type(self):
        return self._payload["type"]

    @property
    def message(self):
        return self._payload["message"]

    @property
    def mapped_data(self):
        return self._payload["mapped_data"]

    def get(self, key, default=None):
        return self._payload["mapped_data"].get(key, default)

    def set(self, key, value):
        self._payload["mapped_data"][key] = value

    def serialize(self) -> str:
        return json.dumps(self._payload)

    @classmethod
    def parse(cls, raw: str) -> "MessageData":
        d = json.loads(raw)
        return cls(d["session_id"], d["type"], d["message"], d.get("mapped_data"))

    def __repr__(self):
        return f"MessageData({self._payload})"


class NodeToken:
    """Addressing record for one node: its command and reply queues (the
    reference's host/port of a ZMQ socket, recode_server.py:118-145)."""

    def __init__(self, node_id: int, command_queue: "queue.Queue", reply_queue: "queue.Queue"):
        self.node_id = node_id
        self.command_queue = command_queue
        self.reply_queue = reply_queue


class NodeClient:
    """Head-side client for one node: sends a request and validates the ack
    (session id, request id, ack type), reference recode_server.py:148-200."""

    def __init__(self, token: NodeToken, session_id: str, timeout: float = 5.0):
        self._token = token
        self._session_id = session_id
        self._timeout = timeout

    def send_request(self, message: str, mapped_data=None) -> bool:
        request_id = f"{self._token.node_id}-{time.monotonic_ns()}"
        md = MessageData(self._session_id, rc.MESSAGE_TYPE_INFO, message, mapped_data)
        md.set("request_id", request_id)
        # drop stale acks of an earlier request the head gave up on
        try:
            while True:
                self._token.reply_queue.get_nowait()
        except queue.Empty:
            pass
        self._token.command_queue.put(md.serialize())
        try:
            raw = self._token.reply_queue.get(timeout=self._timeout)
        except queue.Empty:
            return False
        ack = MessageData.parse(raw)
        return (ack.session_id == self._session_id
                and ack.get("request_id") == request_id
                and ack.type == rc.MESSAGE_TYPE_ACK)


class Logger:
    """Log sink: nodes push records to one queue; a thread prints them live
    and the file gets them on close (reference recode_server.py:203-293)."""

    def __init__(self, session_id: str, log_filename: str = "recode.log"):
        self._session_id = session_id
        self._log_filename = log_filename
        self.queue: "queue.Queue[Optional[str]]" = queue.Queue()
        self._records: List[str] = []
        self._thread: Optional[threading.Thread] = None
        self._echo = True

    def start(self, echo: bool = True) -> None:
        self._echo = echo
        self._thread = threading.Thread(target=self._run, name="recode-logger", daemon=True)
        self._thread.start()

    def push(self, source: str, message: str, message_type=rc.MESSAGE_TYPE_INFO) -> None:
        md = MessageData(self._session_id, message_type, message, {"source": source})
        self.queue.put(md.serialize())

    def _run(self) -> None:
        while True:
            raw = self.queue.get()
            if raw is None:
                break
            md = MessageData.parse(raw)
            line = f"[{md.get('timestamp')}] [{md.get('source', '?')}] {md.message}"
            self._records.append(line)
            if self._echo:
                print(line)

    def close(self) -> None:
        self.queue.put(None)
        if self._thread is not None:
            self._thread.join(timeout=10)
        if self._log_filename:
            Path(self._log_filename).parent.mkdir(parents=True, exist_ok=True)
            with open(self._log_filename, "a") as fp:
                for line in self._records:
                    fp.write(line + "\n")


class ReCoDeNode:
    """Worker thread owning one port writer and its part file; runs the
    command state machine start / process_file / close (reference
    recode_server.py:567-736)."""

    def __init__(self, node_id: int, init_params: InitParams, input_params: InputParams,
                 logger: Logger, session_id: str, fail_on_command=None, resume: bool = False,
                 resume_chunk_offset: int = 0, device="cuda"):
        self.node_id = node_id
        self._init_params = init_params
        self._input_params = input_params
        self._logger = logger
        self._session_id = session_id
        self._device = device
        # fault injection for recovery tests: die on the nth occurrence of a
        # command, given as "cmd" (the first) or ("cmd", n)
        if isinstance(fail_on_command, tuple):
            self._fail_command, self._fail_at_occurrence = fail_on_command
        else:
            self._fail_command, self._fail_at_occurrence = fail_on_command, 1
        # stream-mode replacement: append to the part file, continuing frame
        # ids at resume_chunk_offset
        self._resume = resume
        self._resume_chunk_offset = resume_chunk_offset
        self._writer: Optional[ReCoDeWriter] = None
        self._dark_data = None
        self._data = None
        self.status = rc.STATUS_CODE_NOT_READY
        self.run_metrics: dict = {}
        self.token = NodeToken(node_id, queue.Queue(), queue.Queue())
        self._thread: Optional[threading.Thread] = None

    def start_thread(self, dark_data=None, data=None) -> None:
        self._dark_data = dark_data
        self._data = data
        self._thread = threading.Thread(target=self.run, name=f"recode-node-{self.node_id}",
                                        daemon=True)
        self._thread.start()

    def join(self, timeout=None) -> None:
        if self._thread is not None:
            self._thread.join(timeout)

    def _log(self, message, message_type=rc.MESSAGE_TYPE_INFO):
        self._logger.push(f"node-{self.node_id}", message, message_type)

    def _send_ack(self, request: MessageData) -> None:
        ack = MessageData(self._session_id, rc.MESSAGE_TYPE_ACK, "ack",
                          {"request_id": request.get("request_id")})
        self.token.reply_queue.put(ack.serialize())

    def run(self) -> None:
        """Command loop; mirrors recode_server.py:630-679."""
        self.status = rc.STATUS_CODE_AVAILABLE
        while True:
            request = MessageData.parse(self.token.command_queue.get())
            if request.session_id != self._session_id:
                self._log(f"rejected message from session {request.session_id}",
                          rc.MESSAGE_TYPE_ERROR)
                continue
            command = request.message
            self.status = rc.STATUS_CODE_BUSY
            if command == self._fail_command:
                self._fail_at_occurrence -= 1
                if self._fail_at_occurrence <= 0:
                    self._fail_command = None
                    self._log(f"injected fault on '{command}'", rc.MESSAGE_TYPE_ERROR)
                    self.status = rc.STATUS_CODE_ERROR
                    return
            try:
                if command == "start":
                    self._open()
                    self._writer.start(resume=self._resume,
                                       chunk_offset=self._resume_chunk_offset)
                    self._log("writer started" + (" (resumed)" if self._resume else ""))
                    self._send_ack(request)
                    self.status = rc.STATUS_CODE_AVAILABLE
                elif command == "process_file":
                    self._send_ack(request)
                    self._process_file()
                    self.status = rc.STATUS_CODE_AVAILABLE
                elif command == "close":
                    self._writer.close()
                    self._log("writer closed")
                    self._send_ack(request)
                    self.status = rc.STATUS_CODE_IS_CLOSED
                    return
                else:
                    self._log(f"unknown command: {command}", rc.MESSAGE_TYPE_ERROR)
                    self._send_ack(request)
                    self.status = rc.STATUS_CODE_AVAILABLE
            except Exception:
                self._log(traceback.format_exc(), rc.MESSAGE_TYPE_ERROR)
                self.status = rc.STATUS_CODE_ERROR
                return

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

    def _process_file(self) -> None:
        metrics = self._writer.run(self._data)
        for key, value in metrics.items():
            if key in self.run_metrics:
                try:
                    self.run_metrics[key] += value
                except TypeError:
                    self.run_metrics[key] = value
            else:
                self.run_metrics[key] = value
        self._log(f"processed chunk ({metrics.get('run_frames', 0)} frames)")

    def completed_chunk_offset(self) -> int:
        """Cumulative frame count of chunks this node has fully written."""
        return int(self._writer._chunk_offset) if self._writer is not None else 0


class ReCoDeServer:
    """Head node: orchestrates N thread-mode nodes and a logger."""

    def __init__(self, mode: str = "batch", isolation: str = "thread", device="cuda"):
        isolation = str(isolation).strip().lower()
        if isolation == "process":
            raise NotImplementedError(
                "isolation='process' is not ported yet (ROADMAP Queue 1)")
        if isolation != "thread":
            raise ValueError("isolation must be 'thread' or 'process'")
        self._device = resolve_device(device)
        self._mode = str(mode).strip().lower()
        self._max_attempts = 10
        self._client_timeout = 5.0
        self._session_id = f"rc-{os.getpid()}-{int(time.time())}"

    def _node(self, index: int, logger: Logger, **kwargs) -> ReCoDeNode:
        return ReCoDeNode(index, self._init_params_live, self._input_params_live, logger,
                          self._session_id, device=self._device, **kwargs)

    # ------------------------------------------------------------------- run

    def run(self, init_params: InitParams, input_params: Optional[InputParams] = None,
            dark_data=None, data=None, fail_node_ids=(), fail_node_on_command=None
            ) -> Dict[int, dict]:
        """Run a full acquisition; returns per-node run metrics.

        Mirrors reference recode_server.py:297-403: load and validate
        params, start nodes and logger, broadcast start / process_file /
        close with ack validation, join.  ``fail_node_ids`` /
        ``fail_node_on_command`` inject one fault per listed node for
        recovery tests.
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

        self._init_params_live, self._input_params_live = init_params, input_params
        nodes = [self._node(i, logger,
                            fail_on_command=fail_node_on_command if i in fail_node_ids else None)
                 for i in range(int(input_params.num_threads))]
        self._nodes = nodes  # exposed for tests/monitoring
        for node in nodes:
            node.start_thread(dark_data=dark_data, data=data)
        clients = [NodeClient(node.token, self._session_id, timeout=self._client_timeout)
                   for node in nodes]
        self._dark_data, self._data = dark_data, data

        try:
            self._broadcast(clients, nodes, "start", logger)
            if self._mode == "batch":
                self._broadcast(clients, nodes, "process_file", logger)
                self._wait_until_available(nodes)
                # recover nodes that died mid-processing (one retry round):
                # replace, restart, and re-encode their whole slice
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

    # -------------------------------------------------------------- broadcast

    def _broadcast(self, clients: List[NodeClient], nodes: List[ReCoDeNode],
                   message: str, logger: Logger, retry_delay: float = 0.2) -> None:
        """Reliable broadcast: retry un-acked sends, replace dead nodes (the
        reference leaves the replacement a stub, recode_server.py:405,
        418-440); a replacement re-encodes its node's whole slice."""
        pending = list(range(len(clients)))
        replaced = set()
        for _ in range(self._max_attempts):
            failed = []
            for index in pending:
                if nodes[index].status == rc.STATUS_CODE_ERROR and index not in replaced:
                    self._spawn_replacement_node(index, clients, nodes, logger)
                    replaced.add(index)
                if not clients[index].send_request(message):
                    failed.append(index)
            if not failed:
                return
            pending = failed
            time.sleep(retry_delay)
        for index in pending:
            nodes[index].status = rc.STATUS_CODE_ERROR
            logger.push("head", f"node-{index} unresponsive after "
                                f"{self._max_attempts} attempts", rc.MESSAGE_TYPE_ERROR)

    def _spawn_replacement_node(self, index: int, clients: List[NodeClient],
                                nodes: List[ReCoDeNode], logger: Logger) -> None:
        """Rebuild a failed node in place and bring it back to AVAILABLE.

        Batch mode restarts the part file from the header.  Stream mode
        appends to it (earlier chunks' sources are gone) and continues frame
        ids from the completed-chunk frame counter.
        """
        logger.push("head", f"spawning replacement for node-{index}", rc.MESSAGE_TYPE_ERROR)
        replacement = self._node(index, logger, resume=self._mode == "stream",
                                 resume_chunk_offset=getattr(self, "_stream_chunk_offset", 0))
        replacement.start_thread(dark_data=self._dark_data, data=self._data)
        nodes[index] = replacement
        clients[index] = NodeClient(replacement.token, self._session_id,
                                    timeout=self._client_timeout)
        clients[index].send_request("start")

    @staticmethod
    def _wait_until_available(nodes: List[ReCoDeNode], timeout: float = 3600.0) -> bool:
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            states = {node.status for node in nodes}
            if states <= {rc.STATUS_CODE_AVAILABLE, rc.STATUS_CODE_IS_CLOSED,
                          rc.STATUS_CODE_ERROR}:
                return True
            time.sleep(0.01)
        return False

    # ----------------------------------------------------------- stream mode

    def _recode_queue_manager(self, clients, nodes, init_params: InitParams,
                              logger: Logger) -> None:
        """Directory-watch queue manager (reference recode_server.py:463-564).

        Chunk files appearing in ``directory_path`` are renamed, oldest
        first, to ``Next_Stream.seq``, the nodes process it, and the chunk
        is deleted, so a crash loses at most one chunk.
        """
        watch_dir = Path(init_params.directory_path)
        next_name = watch_dir / "Next_Stream.seq"
        max_count = init_params.max_count if init_params.max_count > 0 else float("inf")
        idle_timeout = max(15.0, float(init_params.chunk_time_in_sec) + 1.0)

        processed = 0
        # cumulative frames of COMPLETED chunks: where a replacement writer's
        # frame counter resumes
        self._stream_chunk_offset = 0
        idle_since = time.monotonic()
        while processed < max_count:
            chunks = sorted((p for p in watch_dir.glob("*.seq") if p.name != "Next_Stream.seq"),
                            key=lambda p: p.stat().st_mtime)
            if not chunks:
                if time.monotonic() - idle_since > idle_timeout:
                    logger.push("head", "stream idle timeout; stopping")
                    break
                time.sleep(0.05)
                continue
            idle_since = time.monotonic()
            chunk = chunks[0]
            os.replace(chunk, next_name)
            self._broadcast(clients, nodes, "process_file", logger)
            if not self._wait_until_available(nodes, timeout=idle_timeout):
                logger.push("head", "nodes unresponsive during stream", rc.MESSAGE_TYPE_ERROR)
                break
            # a node that died during the chunk: its replacement redoes it
            for index, node in enumerate(nodes):
                if node.status == rc.STATUS_CODE_ERROR:
                    self._spawn_replacement_node(index, clients, nodes, logger)
                    clients[index].send_request("process_file")
            if not self._wait_until_available(nodes, timeout=idle_timeout):
                logger.push("head", "nodes unresponsive during stream", rc.MESSAGE_TYPE_ERROR)
                break
            next_name.unlink(missing_ok=True)
            processed += 1
            for node in nodes:
                if node.status != rc.STATUS_CODE_ERROR:
                    self._stream_chunk_offset = max(self._stream_chunk_offset,
                                                    node.completed_chunk_offset())
            logger.push("head", f"processed stream chunk {processed} ({chunk.name})")
