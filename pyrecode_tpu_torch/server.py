"""ReCoDeServer on PyTorch: the head node and thread-mode nodes on one card.

The port's counterpart of pyrecode_tpu/server.py, classes of their own with
the reference server's protocol (recode_server.py:54-773): ``run`` drives N
``ReCoDeNode`` workers and a ``Logger`` through the ack-verified command
sequence start -> process_file* -> close, with the status lifecycle
NOT_READY -> AVAILABLE -> BUSY -> ... -> IS_CLOSED, reliable broadcast with
retries, replacement of failed nodes, and a stream mode that watches a
directory for chunk files.  Each node owns the port's writer and its part
file.  The ZMQ sockets of the reference become queues carrying the same
``MessageData`` envelopes.

``isolation="thread"`` (the default) runs the nodes as threads that share
the one card and launch from their own threads.  ``isolation="process"``
runs each node as a spawned OS process on the host encode path
(``device="cpu"``, ``use_tpu=False``): the worker never initialises CUDA, so
only the head may own the card, and a native crash or SIGKILL of a worker
takes down that worker alone; the head replaces it and the part file resumes.
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
from .profiling import annotate
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
    (session id, request id, ack type), reference recode_server.py:148-200.

    ``alive`` (the node's ``is_alive``) ends the wait for an ack as soon as the
    node's thread or process has ended, rather than at the timeout.
    """

    def __init__(self, token: NodeToken, session_id: str, alive, timeout: float = 5.0):
        self._token = token
        self._session_id = session_id
        self._timeout = timeout
        self._alive = alive

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
        raw = self._wait_for_ack()
        if raw is None:
            return False
        ack = MessageData.parse(raw)
        return (ack.session_id == self._session_id
                and ack.get("request_id") == request_id
                and ack.type == rc.MESSAGE_TYPE_ACK)

    def _wait_for_ack(self):
        deadline = time.monotonic() + self._timeout
        while True:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                return None
            try:
                return self._token.reply_queue.get(timeout=min(remaining, 0.1))
            except queue.Empty:
                pass
            if not self._alive():
                # an ack the node sent just before it ended is still delivered
                try:
                    return self._token.reply_queue.get(timeout=0.1)
                except queue.Empty:
                    return None


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
    recode_server.py:567-736).  Its spans, with the session and node ids:
    ``node.open`` (the writer's construction: threshold, codec, pool) and
    ``node.close`` (the writer's close), besides the writer's own."""

    def __init__(self, node_id: int, init_params: InitParams, input_params: InputParams,
                 logger: Logger, session_id: str, fail_on_command=None, resume: bool = False,
                 resume_chunk_offset: int = 0, device="cuda"):
        self.node_id = node_id
        self._init_params = init_params
        self._input_params = input_params
        self._logger = logger
        self._session_id = session_id
        self._span_args = {"session": session_id, "node": node_id}
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

    def is_alive(self) -> bool:
        return self._thread is not None and self._thread.is_alive()

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
                    with annotate("node.close", self._span_args):
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
        with annotate("node.open", self._span_args):
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
                device=self._device,
                session_id=self._session_id)
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


# -------------------------------------------------- crash-isolated workers


def _process_node_main(node_id, init_params, input_params, session_id, command_q, reply_q,
                       log_q, status_val, chunk_off_val, metrics_q, dark_data, data,
                       fail_on_command, resume, resume_chunk_offset):
    """Entry point of a crash-isolated worker (``isolation="process"``).

    Runs the thread mode's ``ReCoDeNode`` state machine in its own OS
    process, on the host encode path: the writer gets ``device="cpu"`` and
    ``use_tpu=False``, so the worker never initialises CUDA and the card stays
    the head's.  Its run metrics carry ``cuda_initialized``, read when the
    node's loop ends.
    """
    import torch

    init_params._use_tpu = False

    class _MPLogger:
        @staticmethod
        def push(source, message, message_type=rc.MESSAGE_TYPE_INFO):
            try:
                log_q.put((source, message, message_type))
            except (OSError, ValueError):   # the head closed the queue
                pass

    class _SharedStatusNode(ReCoDeNode):
        @property
        def status(self):
            return status_val.value

        @status.setter
        def status(self, value):
            status_val.value = int(value)

        def _process_file(self):
            super()._process_file()
            chunk_off_val.value = self.completed_chunk_offset()

    node = _SharedStatusNode(node_id, init_params, input_params, _MPLogger(), session_id,
                             fail_on_command=fail_on_command, resume=resume,
                             resume_chunk_offset=resume_chunk_offset, device="cpu")
    node.token = NodeToken(node_id, command_q, reply_q)
    node._dark_data = dark_data
    node._data = data
    try:
        node.run()
    finally:
        node.run_metrics["cuda_initialized"] = torch.cuda.is_initialized()
        metrics_q.put(node.run_metrics)


class ProcessNodeHandle:
    """Head-side handle of a crash-isolated worker.  It has the members of
    ``ReCoDeNode`` that the head uses (token, status, start_thread, join,
    run_metrics, completed_chunk_offset), so broadcast, replacement and the
    stream queue manager serve both modes."""

    def __init__(self, node_id: int, init_params: InitParams, input_params: InputParams,
                 log_queue, session_id: str, fail_on_command=None, resume: bool = False,
                 resume_chunk_offset: int = 0):
        import multiprocessing as mp

        self._ctx = mp.get_context("spawn")
        self.node_id = node_id
        self._init_params = init_params
        self._input_params = input_params
        self._log_queue = log_queue
        self._session_id = session_id
        self._fail_on_command = fail_on_command
        self._resume = resume
        self._resume_chunk_offset = resume_chunk_offset
        self._status = self._ctx.Value("i", rc.STATUS_CODE_NOT_READY)
        self._chunk_off = self._ctx.Value("i", int(resume_chunk_offset))
        self._metrics_q = self._ctx.Queue()
        self.token = NodeToken(node_id, self._ctx.Queue(), self._ctx.Queue())
        self._proc = None
        self._forced_status: Optional[int] = None
        self.run_metrics: dict = {}

    def start_thread(self, dark_data=None, data=None) -> None:
        """Starts the worker process (named as ``ReCoDeNode``'s method)."""
        self._proc = self._ctx.Process(
            target=_process_node_main,
            args=(self.node_id, self._init_params, self._input_params, self._session_id,
                  self.token.command_queue, self.token.reply_queue, self._log_queue,
                  self._status, self._chunk_off, self._metrics_q, dark_data, data,
                  self._fail_on_command, self._resume, self._resume_chunk_offset),
            daemon=True, name=f"recode-node-{self.node_id}")
        self._proc.start()

    @property
    def pid(self) -> Optional[int]:
        return self._proc.pid if self._proc is not None else None

    def is_alive(self) -> bool:
        return self._proc is not None and self._proc.is_alive()

    @property
    def status(self) -> int:
        if self._forced_status is not None:
            return self._forced_status
        value = self._status.value
        if (self._proc is not None and not self._proc.is_alive()
                and value != rc.STATUS_CODE_IS_CLOSED):
            return rc.STATUS_CODE_ERROR   # died without closing
        return value

    @status.setter
    def status(self, value) -> None:
        # the head only forces ERROR on an unresponsive node
        self._forced_status = int(value)

    def completed_chunk_offset(self) -> int:
        return int(self._chunk_off.value)

    def join(self, timeout=None) -> None:
        """Waits for the worker and takes its run metrics.  They are read
        before the join: a process does not end while data it queued is
        unread.  A worker that died without them leaves ``run_metrics`` as
        it was."""
        if self._proc is None:
            return
        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            try:
                self.run_metrics = self._metrics_q.get(timeout=0.1)
                break
            except queue.Empty:
                if not self._proc.is_alive() or (deadline is not None
                                                 and time.monotonic() > deadline):
                    try:   # what a worker queued just before it ended
                        self.run_metrics = self._metrics_q.get_nowait()
                    except queue.Empty:
                        pass
                    break
        self._proc.join(None if deadline is None else max(0.0, deadline - time.monotonic()))


class _HeadSpans:
    """The head's spans, one open at a time so that they tile ``run``:
    entering one closes the one before; leaving closes the last."""

    def __init__(self, args: dict):
        self._args, self._name, self._span = args, None, None

    def enter(self, name: str) -> None:
        if name != self._name:
            self.__exit__(None, None, None)
            self._name, self._span = name, annotate(name, self._args)
            self._span.__enter__()

    def __enter__(self) -> "_HeadSpans":
        return self

    def __exit__(self, *exc) -> bool:
        if self._span is not None:
            self._span.__exit__(*exc)
            self._span = None
        return False


class ReCoDeServer:
    """Head node: orchestrates N nodes (threads or processes) and a logger."""

    def __init__(self, mode: str = "batch", isolation: str = "thread", device="cuda"):
        """``isolation``: "thread" (nodes share the process and the card; a
        Python-level node failure is recovered in place) or "process" (each
        node is a spawned OS process on the host encode path that never
        initialises CUDA; a hard crash or SIGKILL of a worker cannot take
        down the head, which replaces it and resumes the part file).
        ``device`` is the head's; "cuda" without CUDA raises in both modes.
        """
        self._isolation = str(isolation).strip().lower()
        if self._isolation not in ("thread", "process"):
            raise ValueError("isolation must be 'thread' or 'process'")
        self._device = resolve_device(device)
        self._mode = str(mode).strip().lower()
        self._max_attempts = 10
        self._client_timeout = 30.0 if self._isolation == "process" else 5.0
        self._session_id = f"rc-{os.getpid()}-{int(time.time())}"
        self._log_mp_queue = None

    def _node(self, index: int, logger: Logger, **kwargs):
        if self._isolation == "process":
            return ProcessNodeHandle(index, self._init_params_live, self._input_params_live,
                                     self._log_mp_queue, self._session_id, **kwargs)
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

        Its spans tile it: ``server.start`` (parameters, logger, nodes, up
        to the last node's ack of start: each node builds and starts its
        writer), ``server.process`` (process_file, the wait for the nodes,
        any recovery round; stream mode's queue manager) and
        ``server.close`` (close: each node's last flush and part-file
        patch; the joins and the log).
        """
        with _HeadSpans({"session": self._session_id}) as phases:
            phases.enter("server.start")
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
            log_drainer = None
            if self._isolation == "process":
                import multiprocessing as mp

                self._log_mp_queue = mp.get_context("spawn").Queue()
                log_drainer = threading.Thread(target=self._drain_worker_logs, args=(logger,),
                                               name="recode-log-drain", daemon=True)
                log_drainer.start()
            nodes = [self._node(i, logger, fail_on_command=(
                         fail_node_on_command if i in fail_node_ids else None))
                     for i in range(int(input_params.num_threads))]
            self._nodes = nodes  # exposed for tests/monitoring
            for node in nodes:
                node.start_thread(dark_data=dark_data, data=data)
            clients = [NodeClient(node.token, self._session_id, node.is_alive,
                                  timeout=self._client_timeout) for node in nodes]
            self._dark_data, self._data = dark_data, data

            try:
                self._broadcast(clients, nodes, "start", logger)
                phases.enter("server.process")
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
                phases.enter("server.close")
                self._broadcast(clients, nodes, "close", logger)
            finally:
                phases.enter("server.close")
                for node in nodes:
                    node.join(timeout=30)
                if log_drainer is not None:
                    self._log_mp_queue.put(None)
                    log_drainer.join(timeout=10)
                logger.push("head", "session closed")
                logger.close()

        return {node.node_id: node.run_metrics for node in nodes}

    def _drain_worker_logs(self, logger: Logger) -> None:
        """Forward the worker processes' log records into the head's Logger."""
        while True:
            try:
                record = self._log_mp_queue.get()
            except (EOFError, OSError):
                return
            if record is None:
                return
            source, message, message_type = record
            logger.push(source, message, message_type)

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
        clients[index] = NodeClient(replacement.token, self._session_id, replacement.is_alive,
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
