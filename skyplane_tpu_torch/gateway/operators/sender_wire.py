"""Pipelined sender wire engine: framer / socket pump / ack reaper.

The serial sender wire loop (one window: frame+send each chunk, then sit in
a blocking ack-collection loop with the socket transmit-idle) pays a full
pipeline drain — frame stall plus ack RTT — at every window boundary. This
engine rebuilds the per-connection data path as a three-stage pipeline so
the socket streams continuously across window boundaries:

  framer (the operator worker thread)
      file read + DataPathProcessor + seal; feeds a bounded frame-ahead
      queue per stream, so the GPU batch runner stays fed while earlier
      frames are still on the wire.
  socket pump (one thread per stream, OWNS the socket)
      streams frames back-to-back under a byte-bounded in-flight window and
      opportunistically reads ack bytes between sends. Single-thread socket
      ownership because concurrent SSL_read/SSL_write on one SSLSocket is
      not safe (the same invariant as the receiver's framing loop).
  ack reaper (one thread per engine)
      consumes the pump's frame-ordered completions concurrently with
      ongoing sends: commits fingerprints to the durable index on ACK,
      rolls back only the affected fps on NACK, re-queues on socket death.

Correctness contracts preserved from the serial path (docs/wire_protocol.md):

  * REF-safety: a chunk may REF fingerprints whose literals were framed
    EARLIER ON THE SAME STREAM but are not yet acked (`pending_fps` — the
    window view generalized to the whole in-flight stream). Striped sibling
    streams get independent pending sets: cross-stream in-flight REFs would
    race frame order on the other socket.
  * Commit-after-delivery: fingerprints enter the durable index only when
    that frame's ack lands (the reaper), never at send time.
  * NACK rollback discards only the nacked frame's REF'd fps (durable and
    pending); the chunk re-queues and resends with literals.
  * Socket death: every un-acked frame's chunk re-queues, the stream's
    pending set resets (nothing uncommitted leaks into the durable index),
    already-acked chunks stay complete — the truthful accounting the serial
    path expressed through BatchPartialFailure.

Adaptive stream count: an engine starts with ONE stream (socket) per
worker and opens up to ``max_streams`` total striped connections when a
submit finds every stream saturated — in-flight window full AND the
frame-ahead queue full, i.e. the wire is the bottleneck and acks lag.
"""

from __future__ import annotations

import mmap
import os
import selectors
import socket
import ssl
import threading
import time
from collections import deque
from typing import Callable, List, Optional

from skyplane_tpu_torch.faults import get_injector
from skyplane_tpu_torch.gateway.operators.gateway_receiver import ACK_BYTE, NACK_UNRESOLVED
from skyplane_tpu_torch.obs import NOOP_SPAN, get_tracer
from skyplane_tpu_torch.utils.logger import logger
from skyplane_tpu_torch.utils.retry import RetryPolicy
from skyplane_tpu_torch.obs import lockwitness as lockcheck

#: reconnect pacing for a stream whose socket keeps dying: jittered
#: exponential (docs/fault-injection.md) — every worker's streams re-dialing
#: a recovering receiver in flat 0.2 s lockstep re-collided by design
RECONNECT_POLICY = RetryPolicy(initial_backoff=0.1, max_backoff=2.0, jitter=0.5)


def env_int(var: str, default: int, minimum: int = 1) -> int:
    """Parse an integer env knob, warning (never raising) on garbage — shared
    by the wire engine and the sender operator's recovery budgets."""
    try:
        return max(minimum, int(os.environ.get(var, str(default))))
    except ValueError:
        logger.fs.warning(f"ignoring malformed {var}; using {default}")
        return default

#: master knob for the raw-forward fast path (docs/datapath-performance.md
#: "Raw-forward fast path"): 0/false/off disables kernel-side splicing
#: everywhere; eligibility is still decided per chunk and per stream
RAW_FORWARD_ENV = "SKYPLANE_TPU_RAW_FORWARD"


def raw_forward_enabled() -> bool:
    return os.environ.get(RAW_FORWARD_ENV, "1").strip().lower() not in ("0", "false", "off")


def send_vectored(sock, header: bytes, payload) -> None:
    """One vectored ``sendmsg([header, payload])`` — header and payload leave
    in a single syscall with NO concatenation copy — with a sendall-style
    resume loop for partial sends. TLS sockets (no sendmsg: OpenSSL owns the
    record layer) and test fakes without sendmsg fall back to two sendalls,
    which is the old behavior exactly."""
    sendmsg = getattr(sock, "sendmsg", None)
    if sendmsg is None or isinstance(sock, ssl.SSLSocket):
        sock.sendall(header)
        if len(payload):
            sock.sendall(payload)
        return
    iov = [memoryview(header), memoryview(payload)]
    iov = [v for v in iov if len(v)]
    while iov:
        sent = sendmsg(iov)
        while iov and sent >= len(iov[0]):
            sent -= len(iov[0])
            iov.pop(0)
        if iov and sent:
            iov[0] = iov[0][sent:]


class RawSendError(OSError):
    """A raw (sendfile/mmap) send failed mid-frame. Distinguished from plain
    socket death so the pump can fall the STREAM back to the codec path
    (requeueing un-acked frames uncounted) instead of burning the circuit
    breaker's reset budget on a mechanism failure."""


class RawFrameSource:
    """The payload of a raw-forwarded frame: a staged file the kernel splices
    to the socket, never materialized as Python bytes on the happy path.

    The frame OWNS the source (the fd rides inside ``os.sendfile`` as a
    borrow, analysis/resources.py) until it resolves — delivered, requeued,
    or failed — when the engine calls :meth:`release` exactly once."""

    __slots__ = ("fd", "length", "_release_fn", "_released")

    def __init__(self, fd: int, length: int, release_fn: Optional[Callable[[], None]] = None):
        self.fd = fd
        self.length = length
        self._release_fn = release_fn
        self._released = False

    def read_all(self) -> bytes:
        """Materialize the payload (codec-path fallback / TLS pread path)."""
        out = bytearray()
        off = 0
        while off < self.length:
            b = os.pread(self.fd, min(1 << 20, self.length - off), off)
            if not b:
                raise OSError(f"staged frame truncated at {off}/{self.length} bytes")
            out += b
            off += len(b)
        return bytes(out)

    def release(self) -> None:
        if self._released:
            return
        self._released = True
        if self._release_fn is not None:
            self._release_fn()
        else:
            try:
                os.close(self.fd)
            except OSError:
                pass


class RawForwardEngine:
    """Kernel-assisted raw sends beside the framer/pump/reaper pipeline.

    Plaintext TCP: the 86-byte wire header goes out as an iovec prefix via
    ``socket.sendmsg`` (MSG_MORE where available, so it coalesces with the
    first payload bytes instead of riding its own segment), then the staged
    payload splices kernel-side with ``os.sendfile`` — zero userspace copies.
    TLS: OpenSSL must see the plaintext, so the payload is written from an
    ``mmap`` view in bounded slices — still no read() copy into Python bytes.
    Any failure raises :class:`RawSendError`; ack/NACK reaping, chunk
    accounting, and egress attribution stay with the caller unchanged."""

    MMAP_SLICE = 4 << 20  # TLS path: bound each SSL_write's plaintext slice

    def send(self, sock, header_bytes: bytes, source: RawFrameSource) -> None:
        inj = get_injector()
        tear_at = -1
        if inj.enabled and inj.fire("sender.raw_send"):
            # docs/fault-injection.md sender.raw_send: tear the splice
            # mid-payload — the receiver sees a truncated frame (connection
            # drop), the sender stream falls back to the codec path
            tear_at = source.length // 2
        try:
            if isinstance(sock, ssl.SSLSocket):
                self._send_mmap(sock, header_bytes, source, tear_at)
            else:
                self._send_sendfile(sock, header_bytes, source, tear_at)
        except RawSendError:
            raise
        except (OSError, ssl.SSLError, ValueError) as e:
            raise RawSendError(f"raw send failed: {e}") from e

    def _send_sendfile(self, sock, header_bytes: bytes, source: RawFrameSource, tear_at: int) -> None:
        flags = getattr(socket, "MSG_MORE", 0) if source.length else 0
        iov = [memoryview(header_bytes)]
        while iov:
            sent = sock.sendmsg(iov, [], flags)
            if sent >= len(iov[0]):
                break
            iov[0] = iov[0][sent:]
        offset = 0
        out_fd = sock.fileno()
        while offset < source.length:
            if 0 <= tear_at <= offset:
                raise RawSendError(f"injected raw splice failure mid-payload at {offset}/{source.length}")
            count = source.length - offset
            if tear_at > offset:
                count = tear_at - offset
            sent = os.sendfile(out_fd, source.fd, offset, count)
            if sent == 0:
                raise RawSendError(f"sendfile stalled at {offset}/{source.length} (staged file truncated?)")
            offset += sent

    def _send_mmap(self, sock, header_bytes: bytes, source: RawFrameSource, tear_at: int) -> None:
        sock.sendall(header_bytes)
        if source.length == 0:
            return
        with mmap.mmap(source.fd, source.length, prot=mmap.PROT_READ) as m:
            with memoryview(m) as view:
                offset = 0
                while offset < source.length:
                    if 0 <= tear_at <= offset:
                        raise RawSendError(f"injected raw splice failure mid-payload at {offset}/{source.length}")
                    end = min(offset + self.MMAP_SLICE, source.length)
                    if tear_at > offset:
                        end = min(end, tear_at)
                    sock.sendall(view[offset:end])
                    offset = end


# stable sender wire-counter schema (the sender mirror of DECODE_COUNTER_ZERO):
# every key always present — zeros when the pipelined engine is off — so
# /profile/socket/sender, bench.py's wire section, and check_bench_json.py can
# rely on the shape without probing which mode is active.
SENDER_WIRE_COUNTER_ZERO = {
    "wire_inflight_bytes": 0,  # gauge: sent-but-unacked bytes across streams
    "wire_stall_ns": 0,  # pump idle with a frame READY but the in-flight window full
    "ack_lag_ns": 0,  # sum over frames of (ack received - frame fully sent)
    "frames_pipelined": 0,  # frames sent while >=1 earlier frame was still unacked
    "streams_open": 0,  # gauge: live striped connections across engines
    "frames_sent": 0,
    "wire_bytes_sent": 0,
    "acks_reaped": 0,
    "nacks_reaped": 0,
    "stream_resets": 0,
    "streams_broken": 0,  # circuit breaker: streams declared dead past the reset budget
    "streams_revived": 0,  # fresh streams opened after every stream broke
    "stream_retargets": 0,  # replan cutovers: streams reset onto a new next hop
    "windows": 0,  # submit batches (the _drain_batch granularity)
    "profile_events_dropped": 0,  # per-window profile events lost to the bounded queue
    # raw-forward fast path (docs/datapath-performance.md): frames whose
    # payload was spliced kernel-side (sendfile) or streamed from an mmap
    # view (TLS), the payload bytes so moved, and raw-send errors that fell
    # a stream back to the codec path
    "wire_raw_frames": 0,
    "wire_raw_bytes": 0,
    "wire_raw_fallbacks": 0,
}


class WireFrame:
    """One framed chunk flowing through the pipeline."""

    __slots__ = (
        "req",
        "header",
        "wire",
        "wire_len",
        "new_fps",
        "ref_fps",
        "relay",
        "raw",
        "sent_ns",
        "sent_wall_ns",
        "window",
        "traced",
        "counted_retry",
    )

    def __init__(
        self,
        req,
        header,
        wire: bytes,
        new_fps=(),
        ref_fps=(),
        relay: bool = False,
        window=None,
        traced: bool = False,
        raw: Optional[RawFrameSource] = None,
    ):
        self.req = req
        self.header = header
        self.wire = wire
        # raw frames carry no in-memory payload: the staged file is the wire
        self.raw = raw
        self.wire_len = raw.length if raw is not None else len(wire)
        self.new_fps = list(new_fps)  # (fp, size) committed to the durable index on ack
        self.ref_fps = list(ref_fps)  # fps discarded on an unresolvable-REF nack
        self.relay = relay  # opaque re-framed bytes: a NACK is unrecoverable
        self.sent_ns = 0
        self.sent_wall_ns = 0
        self.window = window  # optional per-window stats carrier (profile events)
        self.traced = traced  # chunk sampled for tracing (mirrors the header's TRACED flag)
        # False on shutdown-path requeues (abort/close): those are the silent
        # requeue contract, not failures — only real retries (socket death,
        # NACK resend) count against the chunk's retry budget
        self.counted_retry = True

    def release_raw(self) -> None:
        """Release the staged-file borrow (idempotent, no-op on codec
        frames). The engine calls this at every frame resolution —
        delivered, requeued, failed — a requeued chunk re-frames from
        scratch and re-acquires its own source."""
        if self.raw is not None:
            self.raw.release()


class EngineCallbacks:
    """Accounting hooks the engine invokes from its pump/reaper threads.

    The engine owns stream mechanics (pending sets, in-flight windows); the
    callbacks own everything chunk- and index-shaped. All default to no-ops
    so benches and tests can drive the wire loop bare.
    """

    def on_delivered(self, frame: WireFrame) -> None:  # ack landed: commit + complete
        ...

    def on_nack(self, frame: WireFrame) -> None:  # discard REF'd fps from the durable index
        ...

    def on_requeue(self, frame: WireFrame) -> None:  # transient: chunk goes back to the queue
        ...

    def on_failed(self, frame: WireFrame) -> None:  # fatal path: chunk marked failed
        ...

    def on_fatal(self, msg: str) -> None:  # escalate to the daemon error machinery
        ...

    def on_wire_sent(self, nbytes: int) -> None:  # frame bytes hit the socket
        # per-(src,dst)-edge egress attribution (skyplane_egress_bytes_total,
        # docs/blast.md): the operator keys the bytes by its CURRENT target,
        # which only the callback owner knows — the engine stays edge-blind
        ...


class _Stream:
    """One striped connection: frame-ahead queue, in-flight window, pending
    fingerprint view, and the pump thread that owns the socket."""

    __slots__ = (
        "idx",
        "lock",
        "cond",
        "frames",
        "frames_bytes",
        "inflight",
        "inflight_bytes",
        "pending_fps",
        "sock",
        "selector",
        "dead",
        "wake_r",
        "wake_w",
        "thread",
        "consec_resets",
        "broken",
        "retarget",
        "raw_ok",
    )

    def __init__(self, idx: int):
        self.idx = idx
        self.lock = lockcheck.wrap(threading.Lock(), "_Stream.lock")
        self.cond = threading.Condition(self.lock)
        # sklint: disable=unbounded-queue-in-gateway -- submit() blocks at frame_ahead entries; the count bound lives in the producer, not the deque
        self.frames: "deque[WireFrame]" = deque()  # framed, not yet sent
        self.frames_bytes = 0
        # sklint: disable=unbounded-queue-in-gateway -- capped by the engine's inflight_limit byte window (sends gate on inflight_bytes, not entry count)
        self.inflight: "deque[WireFrame]" = deque()  # sent, not yet acked
        self.inflight_bytes = 0
        self.pending_fps: set = set()  # framed-on-this-stream, not yet committed/discarded
        self.sock: Optional[socket.socket] = None
        self.selector: Optional[selectors.BaseSelector] = None
        self.dead = False
        # wake channel: a submit (new frame) nudges the pump out of its ack
        # wait so the frame goes on the wire now, not at the next select tick
        self.wake_r, self.wake_w = socket.socketpair()
        self.wake_r.setblocking(False)
        self.wake_w.setblocking(False)
        self.thread: Optional[threading.Thread] = None
        # circuit-breaker state, touched ONLY by this stream's pump thread:
        # consecutive socket/connect errors with no intervening ack
        self.consec_resets = 0
        self.broken = False  # declared dead past the reset budget
        # replan cutover (docs/provisioning.md "Repair & drain"): set by
        # engine.retarget() from a control thread, consumed by THIS stream's
        # pump thread — which performs the actual reset, preserving the
        # single-thread socket-ownership invariant
        self.retarget = False
        # per-stream raw-forward eligibility: a raw-send error flips this
        # False for the stream's lifetime and every later frame (including
        # requeued ones) ships through the codec path — the mid-stream
        # fallback ladder of docs/datapath-performance.md. Pump thread only.
        self.raw_ok = True

    def wake(self) -> None:
        try:
            self.wake_w.send(b"\x01")
        except OSError:
            pass  # wake already pending (buffer full) or channel torn down

    def load_bytes(self) -> int:
        with self.lock:
            return self.inflight_bytes + self.frames_bytes

    def close_channels(self) -> None:
        if self.selector is not None:
            try:
                self.selector.close()
            except OSError:
                pass
            self.selector = None
        for s in (self.wake_r, self.wake_w):
            try:
                s.close()
            except OSError:
                pass


class SenderWireEngine:
    """Per-worker pipeline coordinator (see module docstring).

    ``socket_factory`` returns a CONNECTED socket to the target (the
    operator's `_make_socket`, including its control handshake and TLS).
    ``callbacks`` is an :class:`EngineCallbacks`. ``frame_fn`` is supplied
    per submit: it receives the chosen stream's pending-fp set and returns a
    :class:`WireFrame` (the framer stage body — file read, DataPathProcessor,
    seal — runs in the SUBMITTING thread, which is the operator worker).
    """

    IDLE_TICK_S = 0.2  # bounds shutdown latency and lost-wake recovery

    def __init__(
        self,
        socket_factory: Callable[[], socket.socket],
        callbacks: EngineCallbacks,
        *,
        inflight_limit_bytes: int = 256 << 20,
        frame_ahead: int = 2,
        max_streams: int = 1,
        ack_timeout_s: float = 30.0,
        name: str = "sender-wire",
        abort_check: Optional[Callable[[], bool]] = None,
        reset_budget: Optional[int] = None,
        revive_budget: Optional[int] = None,
        gateway_id: Optional[str] = None,
    ):
        self.socket_factory = socket_factory
        self.callbacks = callbacks
        # span identity for the merged fleet timeline (docs/observability.md):
        # one shared dict, export copies it — zero per-span allocation
        self.gateway_id = gateway_id
        self._span_args = {"gateway": gateway_id} if gateway_id else None
        # polled while a submit waits on a full frame-ahead queue: lets the
        # framer (the operator worker thread) escape a stalled stream when
        # the daemon is shutting down, instead of wedging worker_loop exit
        self.abort_check = abort_check
        self.inflight_limit = max(1, int(inflight_limit_bytes))
        self.frame_ahead = max(1, int(frame_ahead))
        self.max_streams = max(1, int(max_streams))
        self.ack_timeout_s = float(ack_timeout_s)
        self.name = name
        # circuit breaker (docs/fault-injection.md): a stream is declared dead
        # after reset_budget CONSECUTIVE socket/connect errors (an ack resets
        # the count); its frames re-queue onto healthy/new streams. When EVERY
        # stream is dead, up to revive_budget fresh streams are opened before
        # the engine escalates daemon-fatal — a receiver that never comes back
        # must fail the job loudly, not burn reconnect attempts forever.
        self.reset_budget = reset_budget if reset_budget is not None else env_int("SKYPLANE_TPU_STREAM_RESET_BUDGET", 5)
        self.revive_budget = (
            revive_budget if revive_budget is not None else env_int("SKYPLANE_TPU_STREAM_REVIVE_BUDGET", 2, minimum=0)
        )
        self._revivals = 0  # guarded by _streams_lock
        self._streams: List[_Stream] = []
        self._streams_lock = lockcheck.wrap(threading.Lock(), "SenderWireEngine._streams_lock")
        # sklint: disable=unbounded-queue-in-gateway -- every entry is an in-flight frame, already capped by the per-stream inflight_limit byte windows
        self._completion_q: "deque" = deque()  # (stream, frame, resp byte) in ack order
        self._completion_cond = threading.Condition(lockcheck.wrap(threading.RLock(), "SenderWireEngine._completion_cond"))
        self._counters = dict(SENDER_WIRE_COUNTER_ZERO)
        self._counters_lock = lockcheck.wrap(threading.Lock(), "SenderWireEngine._counters_lock")
        # raw-forward stream mode: kernel-side payload splicing for frames
        # that carry a RawFrameSource (per-stream opt-out via _Stream.raw_ok)
        self.raw_engine = RawForwardEngine()
        self._closed = False
        self._reaper = threading.Thread(target=self._reap, name=f"{name}-reaper", daemon=True)
        self._reaper.start()
        with self._streams_lock:
            self._open_stream_locked()

    # ---- framer-side API ----

    def submit(self, frame_fn: Callable[[set], WireFrame]) -> WireFrame:
        """Frame one chunk onto the least-loaded stream and enqueue it.
        Blocks when the chosen stream's frame-ahead queue is full — that
        backpressure is what bounds per-worker memory to frame_ahead chunks
        per stream. A submit that finds its stream SATURATED (in-flight
        window full AND frame-ahead queue full — the wire is the bottleneck
        and acks lag) stripes a new connection instead of waiting, up to
        ``max_streams``: the chunk is re-framed against the new stream's
        (empty) pending view so REF-safety stays per-socket."""
        stream = self._pick_stream()
        frame = frame_fn(stream.pending_fps)
        while True:
            with stream.lock:
                if stream.dead:
                    # engine shutting down (or mid-break): silent requeue,
                    # not a counted retry — the chunk did not fail, it never
                    # got a live stream
                    frame.counted_retry = False
                    frame.release_raw()
                    self.callbacks.on_requeue(frame)
                    return frame
                if len(stream.frames) < self.frame_ahead:
                    stream.frames.append(frame)
                    stream.frames_bytes += frame.wire_len
                    stream.cond.notify_all()
                    break
                saturated = stream.inflight_bytes >= self.inflight_limit
            if saturated:
                new = self._try_open_stream()
                if new is not None:
                    # the frame's new fps were staged into the old stream's
                    # pending view at frame time; retire them there (their
                    # literal frame will never ride that socket) and re-frame
                    # against the new stream so REFs stay socket-consistent
                    with stream.lock:
                        stream.pending_fps.difference_update(fp for fp, _ in frame.new_fps)
                    stream = new
                    frame.release_raw()  # the re-frame acquires its own source
                    frame = frame_fn(stream.pending_fps)
                    continue
            if self.abort_check is not None and self.abort_check():
                frame.counted_retry = False  # shutdown, not a failure
                frame.release_raw()
                self.callbacks.on_requeue(frame)
                return frame
            with stream.lock:
                if not stream.dead and len(stream.frames) >= self.frame_ahead:
                    stream.cond.wait(self.IDLE_TICK_S)
        stream.wake()
        return frame

    def note_window(self) -> None:
        """Caller marker: one submit batch (= one `_drain_batch` window)."""
        self._bump("windows")

    def retarget(self) -> int:
        """Replan cutover: the operator's target changed (socket_factory now
        dials the new next hop). Flag every live stream for a pump-thread
        reset — un-acked frames re-queue and re-frame onto the new route
        exactly like a stream break, pending fp views clear, and acked chunks
        stay committed (their fps were reaped before the cutover). Returns
        the number of streams flagged."""
        with self._streams_lock:
            streams = list(self._streams)
        n = 0
        for s in streams:
            with s.lock:
                if s.dead:
                    continue
                s.retarget = True
                s.cond.notify_all()
            s.wake()
            n += 1
        return n

    def counters(self) -> dict:
        with self._counters_lock:
            out = dict(self._counters)
        with self._streams_lock:
            streams = list(self._streams)
        out["streams_open"] = sum(1 for s in streams if not s.dead)
        total = 0
        for s in streams:
            with s.lock:
                total += s.inflight_bytes
        out["wire_inflight_bytes"] = total
        return out

    def close(self, drain_timeout_s: float = 2.0) -> None:
        """Drain in-flight frames (bounded), then stop every thread. Frames
        that could not drain re-queue so a restart resends them."""
        deadline = time.monotonic() + max(0.0, drain_timeout_s)
        with self._streams_lock:
            streams = list(self._streams)
        for s in streams:
            with s.lock:
                while (s.frames or s.inflight) and not s.dead and time.monotonic() < deadline:
                    s.cond.wait(min(self.IDLE_TICK_S, max(0.01, deadline - time.monotonic())))
        self._closed = True
        leftovers: List[WireFrame] = []
        for s in streams:
            with s.lock:
                s.dead = True
                leftovers += list(s.inflight) + list(s.frames)
                s.inflight.clear()
                s.frames.clear()
                s.inflight_bytes = s.frames_bytes = 0
                s.pending_fps.clear()
                s.cond.notify_all()
            s.wake()
        for frame in leftovers:
            frame.counted_retry = False  # drained shutdown, not a failure
            frame.release_raw()
            self.callbacks.on_requeue(frame)
        with self._completion_cond:
            self._completion_cond.notify_all()
        for s in streams:
            if s.thread is not None:
                s.thread.join(timeout=1.0)
        self._reaper.join(timeout=1.0)

    # ---- stream management ----

    def _open_stream_locked(self) -> _Stream:
        stream = _Stream(len(self._streams))
        stream.thread = threading.Thread(
            target=self._pump, args=(stream,), name=f"{self.name}-pump{stream.idx}", daemon=True
        )
        self._streams.append(stream)
        stream.thread.start()
        return stream

    def _pick_stream(self) -> _Stream:
        with self._streams_lock:
            live = [s for s in self._streams if not s.dead]
            if not live:
                # every stream broke mid-submit: _break_stream has either
                # revived one (racing this pick) or escalated fatal. Hand back
                # the newest stream — if it is dead, submit()'s dead branch
                # requeues silently and the worker loop observes the error.
                return self._streams[-1]
            best = min(live, key=_Stream.load_bytes)
            if len(self._streams) < self.max_streams and self._saturated(best):
                # every stream has a full in-flight window AND a full
                # frame-ahead queue: acks lag the wire — stripe wider
                return self._open_stream_locked()
        return best

    def _try_open_stream(self) -> Optional[_Stream]:
        with self._streams_lock:
            if self._closed or len(self._streams) >= self.max_streams:
                return None
            return self._open_stream_locked()

    def _saturated(self, stream: _Stream) -> bool:
        with stream.lock:
            return stream.inflight_bytes >= self.inflight_limit and len(stream.frames) >= self.frame_ahead

    # ---- socket pump (one per stream; the ONLY thread touching its socket) ----

    def _pump(self, stream: _Stream) -> None:
        try:
            while True:
                with stream.lock:
                    while not stream.frames and not stream.inflight and not stream.dead and not stream.retarget:
                        stream.cond.wait(self.IDLE_TICK_S)
                    if stream.dead and not stream.frames and not stream.inflight:
                        break
                    do_retarget, stream.retarget = stream.retarget, False
                if do_retarget:
                    # cutover = a deliberate stream break: close the old-hop
                    # socket, requeue un-acked frames (NOT counted against the
                    # chunk retry budget — nothing failed), clear the pending
                    # view; the next _connect dials the new target
                    self._reset_stream(stream, "replan cutover to new next hop", counted=False)
                    self._bump("stream_retargets")
                    continue
                if stream.sock is None and not self._connect(stream):
                    continue
                try:
                    self._pump_once(stream)
                except RawSendError as e:
                    self._raw_fallback(stream, str(e))
                except (OSError, ssl.SSLError) as e:
                    self._stream_error(stream, str(e))
        except Exception:  # noqa: BLE001 — unexpected pump error is daemon-fatal
            import traceback

            self._fatal(f"sender wire pump died: {traceback.format_exc()}")
        finally:
            sock = stream.sock
            stream.sock = None
            if sock is not None:
                try:
                    sock.close()
                except OSError:
                    pass
            stream.close_channels()

    def _connect(self, stream: _Stream) -> bool:
        try:
            inj = get_injector()
            if inj.enabled:
                inj.check("sender.connect", OSError, "injected connect failure")
            sock = self.socket_factory()
        except Exception as e:  # noqa: BLE001 — control POST / TCP / TLS failures retry
            self._stream_error(stream, f"connect failed: {e}")
            return False
        stream.sock = sock
        stream.selector = selectors.DefaultSelector()
        stream.selector.register(sock, selectors.EVENT_READ, "conn")
        stream.selector.register(stream.wake_r, selectors.EVENT_READ, "wake")
        return True

    def _stream_error(self, stream: _Stream, why: str) -> None:
        """One socket/connect failure on this stream (pump thread only):
        reset (re-queue its frames), count it against the consecutive-reset
        budget, and either back off jittered or trip the circuit breaker."""
        self._reset_stream(stream, why)
        stream.consec_resets += 1
        if stream.consec_resets >= self.reset_budget:
            self._break_stream(stream, why)
            return
        time.sleep(RECONNECT_POLICY.backoff_s(stream.consec_resets - 1))

    def _raw_fallback(self, stream: _Stream, why: str) -> None:
        """Mid-stream fallback to the codec path: a raw (sendfile/mmap) send
        failed, possibly leaving a torn frame on the wire. Disable raw mode
        for this stream's lifetime, then reset it like any stream break —
        un-acked frames requeue UNCOUNTED (the mechanism failed, not the
        chunk) and the circuit breaker is NOT charged (a mechanism bug must
        not kill a healthy link)."""
        stream.raw_ok = False
        self._bump("wire_raw_fallbacks")
        logger.fs.warning(f"[{self.name}:stream{stream.idx}] raw-forward disabled, falling back to codec path: {why}")
        self._reset_stream(stream, f"raw-send fallback: {why}", counted=False)

    def _break_stream(self, stream: _Stream, why: str) -> None:
        """Circuit breaker: declare this stream dead. Its frames already
        re-queued (the reset) and re-frame onto healthy streams as the worker
        re-submits them. Only when EVERY stream is dead does the engine act:
        revive one fresh stream (bounded by revive_budget) or escalate
        daemon-fatal — partial failures self-heal, total failure is loud."""
        stream.broken = True
        with stream.lock:
            stream.dead = True
            stream.cond.notify_all()
        stream.wake()
        self._bump("streams_broken")
        logger.fs.warning(
            f"[{self.name}:stream{stream.idx}] circuit breaker: stream dead after "
            f"{stream.consec_resets} consecutive resets ({why})"
        )
        # circuit-breaker trips are fleet-log events (docs/observability.md):
        # a post-mortem must see WHEN each stream died relative to failover/
        # replan decisions, not reconstruct it from warnings
        from skyplane_tpu_torch.obs.events import EV_STREAM_BREAK, get_recorder

        get_recorder().record(
            EV_STREAM_BREAK,
            engine=self.name,
            stream=stream.idx,
            consec_resets=stream.consec_resets,
            why=str(why)[:200],
            gateway=self.gateway_id,
        )
        with self._streams_lock:
            if self._closed:
                return
            all_dead = all(s.dead for s in self._streams)
            revive = all_dead and self._revivals < self.revive_budget
            if revive:
                self._revivals += 1
                self._open_stream_locked()
        if not all_dead:
            return
        if revive:
            self._bump("streams_revived")
            from skyplane_tpu_torch.obs.events import EV_STREAM_REVIVE, get_recorder

            get_recorder().record(
                EV_STREAM_REVIVE, engine=self.name, revivals=self._revivals, gateway=self.gateway_id
            )
            logger.fs.warning(f"[{self.name}] all streams dead; opened replacement stream "
                              f"({self._revivals}/{self.revive_budget} revivals)")
            return
        self._fatal(
            f"all {len(self._streams)} sender streams dead after {self.reset_budget} consecutive "
            f"resets each and {self._revivals} revivals; last error: {why}"
        )

    def _pump_once(self, stream: _Stream) -> None:
        frame = None
        with stream.lock:
            # the window bound gates SENDS, so in-flight bytes are bounded by
            # inflight_limit plus at most one frame; an empty window always
            # admits one frame so an oversized chunk cannot wedge the stream
            if stream.frames and (stream.inflight_bytes < self.inflight_limit or not stream.inflight):
                frame = stream.frames.popleft()
                stream.frames_bytes -= frame.wire_len
                stream.cond.notify_all()  # the framer may enqueue the next chunk
        if frame is not None:
            send_span = (
                get_tracer().span(
                    "wire.send", trace_id=frame.header.chunk_id, cat="sender", force=True, args=self._span_args
                )
                if frame.traced
                else NOOP_SPAN
            )
            inj = get_injector()
            try:
                with send_span:
                    if inj.enabled:
                        # docs/fault-injection.md: sender.send raises a socket
                        # error mid-send; sender.corrupt_payload flips one wire
                        # byte (detectable only on sealed/recipe payloads —
                        # the receiver's auth/structure checks turn it into a
                        # payload error and the chunk resends). Raw frames
                        # have no in-memory payload to corrupt; their torn-
                        # send fault point is sender.raw_send (raw_engine).
                        inj.check("sender.send", OSError, "injected socket error before send")
                        frame.wire = inj.corrupt("sender.corrupt_payload", frame.wire)
                    if frame.raw is not None and not (stream.raw_ok and raw_forward_enabled()):
                        # raw-eligible frame on a raw-disabled stream (or the
                        # knob flipped off): materialize the sealed bytes and
                        # ship them through the codec send — byte-identical
                        # by construction, just a userspace copy slower
                        frame.wire = frame.raw.read_all()
                        frame.release_raw()
                        frame.raw = None
                    if frame.raw is not None:
                        self.raw_engine.send(stream.sock, frame.header.to_bytes(), frame.raw)
                        self._bump("wire_raw_frames")
                        self._bump("wire_raw_bytes", frame.wire_len)
                    else:
                        # codec path: one vectored sendmsg, header as the
                        # iovec prefix — no header-only TCP segment, no
                        # header+payload concatenation copy
                        send_vectored(stream.sock, frame.header.to_bytes(), frame.wire)
            except (OSError, ssl.SSLError):
                # the frame is in-hand (already popped): put it back so the
                # reset path requeues its chunk — otherwise a socket death
                # DURING the send would strand the chunk in_progress forever
                with stream.lock:
                    stream.frames.appendleft(frame)
                    stream.frames_bytes += frame.wire_len
                raise
            frame.sent_ns = time.perf_counter_ns()
            frame.sent_wall_ns = time.time_ns()
            frame.wire = b""  # wire bytes are on the socket; keep only bookkeeping
            with stream.lock:
                pipelined = bool(stream.inflight)
                stream.inflight.append(frame)
                stream.inflight_bytes += frame.wire_len
            self._bump("frames_sent")
            self._bump("wire_bytes_sent", frame.wire_len)
            self.callbacks.on_wire_sent(frame.wire_len)
            if pipelined:
                self._bump("frames_pipelined")
            self._drain_acks(stream, block=False)
            return
        with stream.lock:
            stalled = bool(stream.frames)  # frame ready, in-flight window full
            has_inflight = bool(stream.inflight)
        if not has_inflight:
            return  # outer loop waits for work
        tracer = get_tracer()
        t0 = time.perf_counter_ns() if stalled else 0
        t0_wall = time.time_ns() if (stalled and tracer.enabled) else 0
        self._drain_acks(stream, block=True)
        if stalled:
            stall_ns = time.perf_counter_ns() - t0
            self._bump("wire_stall_ns", stall_ns)
            if tracer.enabled:
                # transmit-idle with a frame READY: the stall the pipelining
                # exists to hide — an async track (it brackets ack waits)
                tracer.record_span("wire.send_stall", stall_ns, t0_wall, cat="sender", args=self._span_args)

    def _drain_acks(self, stream: _Stream, block: bool) -> None:
        """Read response bytes for the in-flight frames, oldest first. With
        ``block``, waits one tick for readability; raises OSError when the
        oldest in-flight frame has outlived the ack timeout (the serial
        path's socket-timeout semantics)."""
        while True:
            with stream.lock:
                if not stream.inflight:
                    return
                oldest_sent = stream.inflight[0].sent_ns
            sock = stream.sock
            pending = getattr(sock, "pending", None)
            readable = bool(pending is not None and sock.pending())
            if not readable:
                try:
                    events = stream.selector.select(self.IDLE_TICK_S if block else 0)
                except (OSError, ValueError):
                    raise OSError("socket torn down mid-select")
                ready = {key.data for key, _ in events}
                if "wake" in ready:
                    try:
                        stream.wake_r.recv(4096)
                    except OSError:
                        pass
                readable = "conn" in ready
            if not readable:
                if block and (time.perf_counter_ns() - oldest_sent) / 1e9 > self.ack_timeout_s:
                    raise OSError(f"no ack for {self.ack_timeout_s:.0f}s with frames in flight")
                return
            b = sock.recv(1)
            if not b:
                raise ConnectionError("peer closed mid-stream")
            if b not in (ACK_BYTE, NACK_UNRESOLVED):
                raise OSError(f"bad/missing chunk ack ({b!r})")
            now = time.perf_counter_ns()
            # a delivered response is proof the connection works: the breaker
            # counts CONSECUTIVE failures only (pump thread owns this field),
            # and a recovered engine earns its full revive budget back — a
            # receiver that comes back after a total outage must not consume
            # the budget permanently (only outages with NO recovery between
            # them should exhaust it)
            stream.consec_resets = 0
            if self._revivals:
                with self._streams_lock:
                    self._revivals = 0
            with stream.lock:
                frame = stream.inflight.popleft()
                stream.inflight_bytes -= frame.wire_len
                stream.cond.notify_all()  # in-flight window opened: sends resume
            self._bump("ack_lag_ns", now - frame.sent_ns)
            if frame.traced:
                # frame-fully-sent -> ack-landed, correlated to the chunk; an
                # async track because later sends overlap this interval
                get_tracer().record_span(
                    "wire.ack_lag",
                    now - frame.sent_ns,
                    frame.sent_wall_ns,
                    trace_id=frame.header.chunk_id,
                    cat="sender",
                    force=True,
                    args=self._span_args,
                )
            with self._completion_cond:
                self._completion_q.append((stream, frame, b))
                self._completion_cond.notify()
            block = False  # past the first ack, only drain what is already here

    def _reset_stream(self, stream: _Stream, why: str, counted: bool = True) -> None:
        """Socket death: close, re-queue every un-sent and un-acked frame,
        reset the pending view (nothing uncommitted leaked — acked frames'
        fps were already committed by the reaper). ``counted=False`` marks the
        requeues as deliberate (replan cutover), exempt from the per-chunk
        retry budget."""
        logger.fs.warning(f"[{self.name}:stream{stream.idx}] socket error mid-stream: {why}")
        self._bump("stream_resets")
        from skyplane_tpu_torch.obs.events import EV_STREAM_RESET, get_recorder

        get_recorder().record(
            EV_STREAM_RESET, engine=self.name, stream=stream.idx, why=str(why)[:200], gateway=self.gateway_id
        )
        with stream.lock:
            doomed = list(stream.inflight) + list(stream.frames)
            stream.inflight.clear()
            stream.frames.clear()
            stream.inflight_bytes = stream.frames_bytes = 0
            stream.pending_fps.clear()
            sock, stream.sock = stream.sock, None
            stream.cond.notify_all()
        if stream.selector is not None:
            # a fresh selector comes with the next connect; closing (not just
            # unregistering) releases the epoll fd of the dead one
            try:
                stream.selector.close()
            except OSError:
                pass
            stream.selector = None
        if sock is not None:
            try:
                sock.close()
            except OSError:
                pass
        for frame in doomed:
            if not counted:
                frame.counted_retry = False
            frame.release_raw()
            self.callbacks.on_requeue(frame)

    # ---- ack reaper (one per engine; never touches a socket) ----

    def _reap(self) -> None:
        try:
            while True:
                with self._completion_cond:
                    while not self._completion_q and not self._closed:
                        self._completion_cond.wait(self.IDLE_TICK_S)
                    if not self._completion_q:
                        if self._closed:
                            return
                        continue
                    stream, frame, b = self._completion_q.popleft()
                if b == ACK_BYTE:
                    self._bump("acks_reaped")
                    frame.release_raw()
                    # commit to the durable index FIRST, then retire the fps
                    # from the stream view — membership (pending ∪ durable)
                    # never has a gap a concurrent framer could fall through
                    self.callbacks.on_delivered(frame)
                    if frame.new_fps:
                        with stream.lock:
                            stream.pending_fps.difference_update(fp for fp, _ in frame.new_fps)
                else:  # NACK_UNRESOLVED
                    self._bump("nacks_reaped")
                    frame.release_raw()
                    if frame.relay:
                        # opaque staged bytes: the recipe cannot be rebuilt and a
                        # re-queue would replay the identical unresolvable frame
                        # forever — fail the stream's outstanding work loudly
                        self._fatal(
                            f"downstream receiver nacked relayed chunk {frame.req.chunk.chunk_id} "
                            "(unresolvable dedup ref; relay cannot rebuild the recipe)",
                            frame,
                        )
                        return
                    self.callbacks.on_nack(frame)  # durable-index rollback
                    with stream.lock:
                        for fp in frame.ref_fps:
                            stream.pending_fps.discard(fp)
                        # the nacked frame's OWN literals are unproven too (the
                        # receiver rejected the frame before acking): retire
                        # them from the pending view, or the resend would REF
                        # segments that may never have been stored and park the
                        # receiver for a full ref-wait before a second NACK.
                        # Worst case this costs a duplicate literal (dedup
                        # miss) — never a stall, never corruption.
                        for fp, _ in frame.new_fps:
                            stream.pending_fps.discard(fp)
                    self.callbacks.on_requeue(frame)  # resend with literals
        except Exception:  # noqa: BLE001 — unexpected reaper error is daemon-fatal
            import traceback

            self._fatal(f"sender wire reaper died: {traceback.format_exc()}")

    def _fatal(self, msg: str, frame: Optional[WireFrame] = None) -> None:
        """Unrecoverable: fail the nacked frame plus everything still queued
        or in flight (the BatchPartialFailure truth: acked chunks stay
        complete, the rest are failed), then escalate."""
        doomed = [frame] if frame is not None else []
        with self._streams_lock:
            streams = list(self._streams)
        for s in streams:
            with s.lock:
                s.dead = True
                doomed += list(s.inflight) + list(s.frames)
                s.inflight.clear()
                s.frames.clear()
                s.inflight_bytes = s.frames_bytes = 0
                s.cond.notify_all()
            s.wake()
        self._closed = True
        # honour responses already reaped off the wire before failing the
        # rest: a completion sitting in the queue is a durably delivered (or
        # definitively nacked) chunk — "acked chunks stay complete" must hold
        # even when the fatal interleaves with in-flight completions
        with self._completion_cond:
            leftovers = list(self._completion_q)
            self._completion_q.clear()
            self._completion_cond.notify_all()
        for _stream, f, b in leftovers:
            if b == ACK_BYTE:
                self._bump("acks_reaped")
                f.release_raw()
                self.callbacks.on_delivered(f)
            else:
                doomed.append(f)
        for f in doomed:
            f.release_raw()
            self.callbacks.on_failed(f)
        self.callbacks.on_fatal(msg)

    def _bump(self, key: str, n: int = 1) -> None:
        with self._counters_lock:
            self._counters[key] += n
