"""Cluster rendezvous control plane.

A copy of ``tensorflowonspark_tpu/reservation.py`` with its imports rewritten.

Reference anchor: ``tensorflowonspark/reservation.py`` (``Reservations``,
``MessageSocket``, ``Server``, ``Client``).

Role: the driver starts a :class:`Server` expecting ``count`` nodes; every
executor-side node registers its metadata (host, ports, role, authkey, …) via
a :class:`Client` and then blocks until all ``count`` nodes are present, at
which point every node receives the full cluster spec.  This barrier is what
seeds ``jax.distributed.initialize`` in the TPU rebuild (the node with
``executor_id == 0`` publishes its coordinator address through the built-in
key/value blackboard).

Deliberate departures from the reference design:

- **JSON wire format, not pickle.**  The reference pickles messages; pickle
  over a socket is an RCE hazard and buys nothing here since node metadata is
  plain data.  Messages are 4-byte big-endian length-prefixed UTF-8 JSON.
- **A key/value blackboard lives on the server** (``put``/``get``).  The
  reference scatters this role across the per-executor ``TFManager`` kv dict
  (e.g. the TensorBoard URL); centralising it on the rendezvous server means
  any node or the driver can read it without knowing which executor wrote it.
- **An auth token** (random, carried in ``cluster_meta``) must accompany every
  message; the reference's server trusts any connection.
- **Rendezvous generations** (elastic membership): the server
  carries a monotonically increasing ``generation``.  The initial bootstrap
  barrier is generation 0; every regroup after an executor loss opens the
  next one (:meth:`Server.begin_generation`, driven by
  :class:`tensorflowonspark_torch.elastic.ElasticSupervisor`).  Messages MAY
  stamp a ``gen`` field — a stamped message older than the server's current
  generation is rejected (:class:`StaleGenerationError` client-side), so a
  zombie executor of generation N cannot corrupt the kv or the barriers of
  generation N+1.  A registration stamped with a FUTURE generation is
  parked and absorbed when that generation opens — a late or replacement
  executor lands in the *next* regroup instead of being refused.
  Unstamped messages are never fenced (pre-elastic compatibility: error
  attributions and the TensorBoard URL must flow regardless of membership
  churn).
"""

from __future__ import annotations

import json
import logging
import os
import random
import secrets
import socket
import struct
import threading
import time
from typing import Any

logger = logging.getLogger(__name__)

_LEN = struct.Struct(">I")
_MAX_MSG = 64 * 1024 * 1024

#: transient socket-level failures worth retrying: the server socket being
#: torn down/rebuilt (driver restart, a regroup racing the listener) shows
#: up as refused/reset/aborted connections for a bounded window
_RETRYABLE_ERRORS = (ConnectionRefusedError, ConnectionResetError,
                     ConnectionAbortedError, BrokenPipeError, TimeoutError)


class StaleGenerationError(RuntimeError):
    """The server rejected a message stamped with a past generation — the
    caller is a zombie of a membership epoch that has been regrouped away.
    Deliberately NOT retried by the client: backing off cannot make a
    stale generation current again."""


class MessageSocket:
    """Length-prefixed JSON messages over a connected TCP socket.

    Reference anchor: ``tensorflowonspark/reservation.py::MessageSocket``.
    """

    def __init__(self, sock: socket.socket):
        self.sock = sock

    def send(self, msg: dict[str, Any]) -> None:
        data = json.dumps(msg, separators=(",", ":")).encode("utf-8")
        self.sock.sendall(_LEN.pack(len(data)) + data)

    def recv(self) -> dict[str, Any] | None:
        header = self._recv_exact(_LEN.size)
        if header is None:
            return None
        (length,) = _LEN.unpack(header)
        if length > _MAX_MSG:
            raise ValueError(f"message too large: {length}")
        data = self._recv_exact(length)
        if data is None:
            return None
        return json.loads(data.decode("utf-8"))

    def _recv_exact(self, n: int) -> bytes | None:
        buf = bytearray()
        while len(buf) < n:
            chunk = self.sock.recv(n - len(buf))
            if not chunk:
                return None
            buf.extend(chunk)
        return bytes(buf)

    def close(self) -> None:
        try:
            self.sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        self.sock.close()


class Reservations:
    """Thread-safe registry of node reservations with a completion barrier.

    Reference anchor: ``tensorflowonspark/reservation.py::Reservations``.
    """

    def __init__(self, required: int):
        self.required = required
        self._lock = threading.Condition()
        # Keyed by executor_id so a Spark-retried bootstrap task that
        # re-registers *replaces* its stale entry (latest wins) instead of
        # double-counting and releasing the barrier with a malformed spec.
        self._by_id: dict[Any, dict[str, Any]] = {}
        self._anon: list[dict[str, Any]] = []

    def add(self, meta: dict[str, Any]) -> None:
        with self._lock:
            eid = meta.get("executor_id")
            if eid is None:
                self._anon.append(meta)
            else:
                if eid in self._by_id:
                    logger.warning(
                        "executor %s re-registered; replacing stale entry", eid
                    )
                self._by_id[eid] = meta
            if self.done():
                self._lock.notify_all()

    def _count(self) -> int:
        return len(self._by_id) + len(self._anon)

    def done(self) -> bool:
        return self._count() >= self.required

    def get(self) -> list[dict[str, Any]]:
        with self._lock:
            # numeric ids sort numerically (10 after 2); mixed types are
            # grouped so consumers mapping position → process index are safe
            ordered = sorted(
                self._by_id.items(), key=lambda kv: (isinstance(kv[0], str), kv[0])
            )
            return [m for _k, m in ordered] + list(self._anon)

    def remaining(self) -> int:
        with self._lock:
            return max(0, self.required - self._count())

    def wait(self, timeout: float | None = None) -> bool:
        """Block until all reservations are in; True on success."""
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._lock:
            while not self.done():
                remaining = None
                if deadline is not None:
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        return False
                self._lock.wait(remaining)
            return True


class Server:
    """Driver-side rendezvous listener.

    Reference anchor: ``tensorflowonspark/reservation.py::Server``.  Handles
    ``REG`` (register node meta), ``QINFO`` (poll cluster info), ``QUERY``
    (all registered?), ``PUT``/``GET`` (kv blackboard), ``STOP``.
    """

    def __init__(self, count: int, auth_token: str | None = None):
        self.reservations = Reservations(count)
        self.auth_token = auth_token or secrets.token_hex(16)
        self._kv: dict[str, Any] = {}
        self._kv_lock = threading.Condition()
        self._stop = threading.Event()
        self._listener: socket.socket | None = None
        self.address: tuple[str, int] | None = None
        #: current membership generation: 0 = the bootstrap barrier; each
        #: elastic regroup opens the next (see module docstring)
        self.generation = 0
        self._gen_lock = threading.Condition()
        #: per-regroup-generation barriers (gen ≥ 1); gen 0 is
        #: :attr:`reservations`
        self._regroups: dict[int, Reservations] = {}
        #: registrations stamped with a future generation, parked until
        #: that generation opens (late/replacement executors)
        self._parked: list[dict[str, Any]] = []

    # -- generations (elastic membership) ----------------------------------

    def begin_generation(self, gen: int, count: int) -> Reservations:
        """Open regroup generation ``gen`` expecting ``count`` NEW
        registrations (the survivors).

        Driver in-process API (the elastic supervisor calls this before
        broadcasting the regroup command).  From this moment every stamped
        message of an earlier generation is rejected.  Registrations
        parked for a future generation (late/replacement executors) are
        absorbed into this one IN ADDITION to ``count`` — they must not
        consume survivor slots, or the barrier would release before every
        survivor rejoined (the supervisor sizes ``count`` to the
        survivors it commanded to regroup).
        """
        with self._gen_lock:
            if gen <= self.generation:
                raise ValueError(
                    f"generation {gen} is not past the current "
                    f"generation {self.generation}")
            parked, self._parked = self._parked, []
            res = Reservations(count + len(parked))
            self._regroups[gen] = res
            self.generation = gen
            self._gen_lock.notify_all()
        try:
            # lazy import: reservation is the bottom layer and must not
            # import obs at module scope; the journal records the fence
            # opening — the happens-before edge the total order leans on
            from tensorflowonspark_torch.obs import journal as _journal

            _journal.emit("generation.begin", gen=gen, expected=count,
                          parked=len(parked))
        except Exception:  # pragma: no cover - observability best effort
            pass
        for meta in parked:
            logger.info(
                "absorbing parked registration of executor %s into "
                "generation %d", meta.get("executor_id"), gen)
            res.add(meta)
        return res

    def await_generation(self, gen: int,
                         timeout: float | None = None) -> list[dict[str, Any]]:
        """Block until generation ``gen``'s regroup barrier completes;
        returns the new membership's cluster info (driver in-process)."""
        res = self._reservations_for(gen)
        if not res.wait(timeout):
            raise TimeoutError(
                f"timed out waiting for {res.remaining()} of "
                f"{res.required} nodes to rejoin generation {gen}")
        return res.get()

    def _reservations_for(self, gen: int) -> Reservations:
        if gen == 0:
            return self.reservations
        with self._gen_lock:
            res = self._regroups.get(gen)
        if res is None:
            raise KeyError(f"generation {gen} was never opened")
        return res

    def kv_put(self, key: str, value: Any) -> None:
        """In-process write to the kv blackboard (driver side — the
        supervisor's regroup broadcast goes through here)."""
        with self._kv_lock:
            self._kv[key] = value
            self._kv_lock.notify_all()

    def start(self) -> tuple[str, int]:
        """Bind, spawn the accept loop thread, return ``(host, port)``."""
        from tensorflowonspark_torch import util

        sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        sock.bind(("", 0))
        sock.listen(64)
        self._listener = sock
        self.address = (util.get_ip_address(), sock.getsockname()[1])
        threading.Thread(
            target=self._accept_loop, name="tfos-reservation-server", daemon=True
        ).start()
        logger.info("reservation server listening on %s", self.address)
        return self.address

    def await_reservations(self, timeout: float | None = None) -> list[dict[str, Any]]:
        """Block until every node registered; return the cluster info."""
        if not self.reservations.wait(timeout):
            raise TimeoutError(
                f"timed out waiting for {self.reservations.remaining()} of "
                f"{self.reservations.required} nodes to register"
            )
        return self.reservations.get()

    def kv_get(self, key: str, default: Any = None) -> Any:
        """In-process read of the kv blackboard (driver side — no socket)."""
        with self._kv_lock:
            return self._kv.get(key, default)

    def kv_items(self, prefix: str = "") -> dict[str, Any]:
        """In-process snapshot of kv entries under ``prefix`` (driver
        side).  Lets the driver enumerate per-node keys it cannot name in
        advance — e.g. the durable ``node_error:<job>:<idx>`` attributions
        nodes publish here precisely because this kv OUTLIVES their own
        managers (the orphan watch reaps a dead trainer's blackboard
        after ~15 s; this server lives until ``TFCluster.shutdown``)."""
        with self._kv_lock:
            return {k: v for k, v in self._kv.items()
                    if k.startswith(prefix)}

    def stop(self) -> None:
        self._stop.set()
        if self._listener is not None:
            try:
                self._listener.close()
            except OSError:
                pass

    # -- internals ---------------------------------------------------------

    def _accept_loop(self) -> None:
        assert self._listener is not None
        while not self._stop.is_set():
            try:
                conn, _addr = self._listener.accept()
            except OSError:
                break
            threading.Thread(
                target=self._serve_conn, args=(conn,), daemon=True
            ).start()

    def _serve_conn(self, conn: socket.socket) -> None:
        ms = MessageSocket(conn)
        try:
            while not self._stop.is_set():
                msg = ms.recv()
                if msg is None:
                    break
                if msg.get("auth") != self.auth_token:
                    ms.send({"ok": False, "error": "bad auth token"})
                    break
                try:
                    reply = self._handle(msg)
                except Exception as e:
                    # an unexpected handler failure must become an error
                    # REPLY, not a dead serve thread — a thread that dies
                    # between recv and send leaves the client blocked in
                    # its socket read forever
                    logger.warning("reservation handler failed on %s: %s",
                                   msg.get("type"), e)
                    reply = {"ok": False,
                             "error": f"handler failed: {e!r}"[:200]}
                ms.send(reply)
                if msg.get("type") == "STOP":
                    break
        except (OSError, ValueError) as e:
            logger.debug("reservation connection error: %s", e)
        finally:
            ms.close()

    def _handle(self, msg: dict[str, Any]) -> dict[str, Any]:
        mtype = msg.get("type")
        gen = msg.get("gen")
        if gen is not None:
            gen = int(gen)
            with self._gen_lock:
                current = self.generation
            if gen < current:
                # generation fencing: a zombie of a regrouped-away epoch
                # must fail loudly, not corrupt the current epoch's state
                return {"ok": False, "stale_generation": True,
                        "current_gen": current,
                        "error": f"stale generation {gen} "
                                 f"(current {current})"}
        if mtype == "REG":
            if gen is not None and gen > self.generation:
                # a future-generation registration: a late or replacement
                # executor asking into the NEXT regroup — park it; it is
                # absorbed when the supervisor opens that generation.
                # Latest-wins dedup by executor_id, mirroring
                # Reservations.add: a client-retried REG (reply lost to a
                # transient reset) must not park twice — each parked entry
                # inflates the regroup barrier's required count, and a
                # phantom member would make the barrier unmeetable.
                with self._gen_lock:
                    if gen > self.generation:
                        eid = msg["meta"].get("executor_id")
                        if eid is not None:
                            self._parked = [
                                m for m in self._parked
                                if m.get("executor_id") != eid]
                        self._parked.append(msg["meta"])
                        logger.info(
                            "parked registration of executor %s for future "
                            "generation %d (current %d)",
                            msg["meta"].get("executor_id"), gen,
                            self.generation)
                        return {"ok": True, "parked": True,
                                "current_gen": self.generation}
            target = (self.reservations if gen is None
                      else self._reservations_for(gen))
            target.add(msg["meta"])
            return {"ok": True}
        if mtype == "QUERY":
            return {"ok": True, "done": self.reservations.done()}
        if mtype == "QGEN":
            # current-generation query: a node that wants to JOIN a live
            # membership (serving-mesh replica, replacement executor)
            # registers for generation current+1 — which it can only name
            # after asking.  Never fenced: the asker is by definition not
            # yet a member of any generation.
            with self._gen_lock:
                return {"ok": True, "gen": self.generation}
        if mtype == "QINFO":
            done = self.reservations.done()
            return {
                "ok": True,
                "done": done,
                "cluster": self.reservations.get() if done else None,
            }
        if mtype == "WAIT":
            # Server-side blocking wait on the registration barrier — one
            # connection per node instead of the reference's poll loop
            # (``reservation.py::Client.await_reservations`` polls QINFO).
            timeout = msg.get("timeout", 30.0)
            if gen is not None and gen > 0:
                deadline = time.monotonic() + timeout
                with self._gen_lock:
                    # a barrier wait may arrive before the supervisor
                    # opens the generation — block until it exists
                    while gen > self.generation:
                        remaining = deadline - time.monotonic()
                        if remaining <= 0:
                            return {"ok": True, "done": False,
                                    "cluster": None}
                        self._gen_lock.wait(remaining)
                res = self._reservations_for(gen)
                done = res.wait(timeout=max(0.0,
                                            deadline - time.monotonic()))
                return {"ok": True, "done": done,
                        "cluster": res.get() if done else None}
            done = self.reservations.wait(timeout=timeout)
            return {
                "ok": True,
                "done": done,
                "cluster": self.reservations.get() if done else None,
            }
        if mtype == "PUT":
            self.kv_put(msg["key"], msg["value"])
            return {"ok": True}
        if mtype == "GET":
            with self._kv_lock:
                timeout = msg.get("timeout", 0.0)
                deadline = time.monotonic() + timeout
                while msg["key"] not in self._kv:
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        break
                    self._kv_lock.wait(remaining)
                present = msg["key"] in self._kv
                return {
                    "ok": True,
                    "found": present,
                    "value": self._kv.get(msg["key"]),
                }
        if mtype == "STOP":
            self._stop.set()
            if self._listener is not None:
                try:
                    self._listener.close()
                except OSError:
                    pass
            return {"ok": True}
        return {"ok": False, "error": f"unknown message type {mtype!r}"}


class Client:
    """Executor-side rendezvous client.

    Reference anchor: ``tensorflowonspark/reservation.py::Client``.  One TCP
    connection per call keeps the client trivially fork/spawn-safe (the
    reference holds one long-lived socket, which breaks when the background
    trainer process inherits it).
    """

    #: bounded retry budget for transient socket errors (see :meth:`_call`);
    #: override per client or via ``TFOS_RESERVATION_RETRIES``
    DEFAULT_RETRIES = 4
    #: first backoff sleep; doubles per attempt, jittered ±50%, capped
    BACKOFF_BASE_S = 0.2
    BACKOFF_CAP_S = 5.0

    def __init__(self, server_addr: tuple[str, int] | list, auth_token: str,
                 generation: int | None = None, retries: int | None = None):
        self.server_addr = (server_addr[0], int(server_addr[1]))
        self.auth_token = auth_token
        #: when set, every message is stamped with this generation and the
        #: server fences it (elastic membership; see module docstring)
        self.generation = generation
        if retries is None:
            retries = int(os.environ.get("TFOS_RESERVATION_RETRIES",
                                         str(self.DEFAULT_RETRIES)))
        self.retries = max(0, retries)

    def _call(self, msg: dict[str, Any], timeout: float = 30.0,
              retries: int | None = None) -> dict[str, Any]:
        """One request/reply, with bounded retry on *transient socket*
        errors (connection refused/reset/aborted, timeouts — the signatures
        of a driver restart or a listener mid-regroup), exponential backoff
        with jitter between attempts, each retry logged so flake rates
        stay visible.  Server-level error replies are never retried: a
        semantic rejection (bad auth, stale generation) cannot heal by
        waiting."""
        if self.generation is not None and "gen" not in msg:
            msg = dict(msg, gen=self.generation)
        msg = dict(msg, auth=self.auth_token)
        if retries is None:
            retries = self.retries
        last_exc: Exception | None = None
        for attempt in range(retries + 1):
            if attempt:
                delay = min(self.BACKOFF_CAP_S,
                            self.BACKOFF_BASE_S * (2 ** (attempt - 1)))
                delay *= 0.5 + random.random()  # ±50% jitter: no stampedes
                logger.warning(
                    "reservation %s to %s failed (%s); retry %d/%d in "
                    "%.2fs", msg.get("type"), self.server_addr, last_exc,
                    attempt, retries, delay)
                time.sleep(delay)
            try:
                return self._call_once(msg, timeout)
            except _RETRYABLE_ERRORS as e:
                last_exc = e
            except ConnectionError as e:
                # server closed mid-exchange (listener torn down under us)
                last_exc = e
        assert last_exc is not None
        raise last_exc

    def _call_once(self, msg: dict[str, Any], timeout: float) -> dict[str, Any]:
        sock = socket.create_connection(self.server_addr, timeout=timeout)
        ms = MessageSocket(sock)
        try:
            ms.send(msg)
            reply = ms.recv()
        finally:
            ms.close()
        if reply is None:
            raise ConnectionError("reservation server closed connection")
        if not reply.get("ok", False):
            if reply.get("stale_generation"):
                raise StaleGenerationError(
                    f"reservation server rejected generation "
                    f"{msg.get('gen')}: {reply.get('error')}")
            raise RuntimeError(f"reservation server error: {reply.get('error')}")
        return reply

    def register(self, node_meta: dict[str, Any]) -> None:
        self._call({"type": "REG", "meta": node_meta})

    def await_reservations(
        self, timeout: float = 600.0, poll_interval: float = 0.2
    ) -> list[dict[str, Any]]:
        """Block until the whole cluster registered; return cluster info.

        Uses a server-side blocking wait (one connection, chunked so a dead
        server is noticed) rather than the reference's QINFO poll loop.
        ``poll_interval`` is kept for signature parity; it is unused.
        """
        del poll_interval
        deadline = time.monotonic() + timeout
        while True:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                raise TimeoutError(
                    f"timed out after {timeout}s waiting for cluster reservations"
                )
            chunk = min(remaining, 30.0)
            reply = self._call(
                {"type": "WAIT", "timeout": chunk}, timeout=chunk + 30.0
            )
            if reply["done"]:
                return reply["cluster"]

    def current_generation(self) -> int:
        """The server's current membership generation (``QGEN``).

        A node joining a LIVE membership registers for generation
        ``current + 1`` (the server parks the registration until the next
        regroup absorbs it) — this query is how it names that generation.
        Deliberately unstamped even on a generation-stamped client:
        asking "what is current?" must work from any epoch.
        """
        reply = self._call({"type": "QGEN", "gen": None})
        return int(reply["gen"])

    def put(self, key: str, value: Any) -> None:
        """Publish to the cluster-wide kv blackboard."""
        self._call({"type": "PUT", "key": key, "value": value})

    def get(self, key: str, timeout: float = 0.0) -> Any:
        """Read from the blackboard; block up to ``timeout`` for the key."""
        reply = self._call(
            {"type": "GET", "key": key, "timeout": timeout},
            timeout=max(30.0, timeout + 10.0),
        )
        if not reply["found"]:
            raise KeyError(key)
        return reply["value"]

    def request_stop(self) -> None:
        try:
            # no retries: a refused connection means the server is already
            # gone, which is the goal — backing off would only slow teardown
            self._call({"type": "STOP"}, retries=0)
        except (ConnectionError, OSError):
            pass  # server already gone — that's what we wanted
