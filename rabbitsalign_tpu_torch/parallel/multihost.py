"""Multi-host data-parallel mapping over torch.distributed (gloo).

Counterpart of rabbitsalign_tpu/parallel/multihost.py, the scale-out
design of the JAX package (the reference has no distributed layer): every
host runs the same command and reads the whole read stream, maps only the
chunks with ``index % N == node id`` through the normal NativePipeline,
and writes an output shard ``<out>.part<P>of<N>`` with a manifest of its
chunk indices; node 0 merges the shards into chunk order after a barrier,
writing the SAM header first. Statistics are summed over the pod.

The pod is a torch.distributed process group over gloo: everything it
reduces is a handful of host numbers, so no collective touches a card.
`shard_chunks`, `ShardWriter` and `merge_output` are copies of the JAX
package's host code and write the same bytes and manifests.

With ``--pod-index-peers`` the index itself is split over the hosts
(`PodShardedIndex`): each holds only its run-aligned hash-range slice,
on its ``--device``, and answers the keys it owns for its peers over a
TCP side channel.
"""

from __future__ import annotations

import contextlib
import json
import os
import socket
import struct
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from datetime import timedelta
from typing import Iterable, List, Optional, Tuple

import numpy as np
import torch

from ..ops import shard_cuda
from .sharding import _UPLOAD_LOCK, SENTINEL, _put, check_devices, shard_bounds


def _pod_timeout() -> timedelta:
    """The gloo rendezvous and collective timeout: ``RSB_POD_TIMEOUT``
    seconds, default 1800 (a barrier waits for the slowest host)."""
    return timedelta(seconds=float(os.environ.get("RSB_POD_TIMEOUT", "1800")))


def init_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> Tuple[int, int]:
    """Join the pod's gloo process group (a no-op for one process) and
    return (rank, world size). With `num_processes` > 1 the rendezvous is
    at ``tcp://<coordinator_address>`` (node 0 listens there), or, without
    an address, through the ``env://`` variables (MASTER_ADDR,
    MASTER_PORT); without `num_processes`, a set MASTER_ADDR and
    WORLD_SIZE form an env-configured pod, as JAX_COORDINATOR_ADDRESS
    does for the JAX package."""
    import torch.distributed as dist

    if num_processes is not None and num_processes > 1:
        init = f"tcp://{coordinator_address}" if coordinator_address else "env://"
        dist.init_process_group("gloo", init_method=init, world_size=num_processes,
                                rank=process_id, timeout=_pod_timeout())
    elif os.environ.get("MASTER_ADDR") and os.environ.get("WORLD_SIZE"):
        dist.init_process_group("gloo", init_method="env://", timeout=_pod_timeout())
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def barrier() -> None:
    """Wait for every host of the pod (the JAX package's
    `multihost_utils.sync_global_devices`); a no-op for one process."""
    import torch.distributed as dist

    if dist.is_initialized():
        dist.barrier()


def shutdown_distributed() -> None:
    """Leave the pod's process group, so that no process hangs at exit."""
    import torch.distributed as dist

    if dist.is_initialized():
        dist.destroy_process_group()


def shard_chunks(
    chunks: Iterable, process_index: int, process_count: int
) -> Iterable:
    """Round-robin chunk sharding by chunk index: host p maps chunks with
    index % process_count == p. Every host reads the input stream (cheap
    relative to mapping; index parsing is sequential) but only seeds and
    aligns its own shard."""
    for item in chunks:
        chunk_index = item[0]
        if chunk_index % process_count == process_index:
            yield item


class ShardWriter:
    """Writes one host's output shard plus a chunk-index manifest so the
    shards can be merged back into global chunk order."""

    def __init__(self, base_path: str, process_index: int, process_count: int):
        self.process_count = process_count
        self.process_index = process_index
        if process_count == 1:
            self.path = base_path
        else:
            self.path = f"{base_path}.part{process_index}of{process_count}"
        self._f = open(self.path, "wb")
        self._manifest: List[Tuple[int, int]] = []  # (chunk_index, n_bytes)

    def write_chunk(self, chunk_index: int, text) -> None:
        data = text if isinstance(text, bytes) else text.encode()
        self._f.write(data)
        self._manifest.append((chunk_index, len(data)))

    def close(self) -> None:
        self._f.close()
        if self.process_count > 1:
            with open(self.path + ".manifest", "w") as m:
                json.dump(self._manifest, m)


def merge_output(base_path: str, process_count: int, header: str = "") -> None:
    """Merge per-host shards into `base_path` in global chunk order."""
    entries = []
    paths = []
    for p in range(process_count):
        path = f"{base_path}.part{p}of{process_count}"
        paths.append(path)
        with open(path + ".manifest") as m:
            manifest = json.load(m)
        off = 0
        for chunk_index, n in manifest:
            entries.append((chunk_index, path, off, n))
            off += n
    entries.sort()
    with open(base_path, "wb") as out:
        if header:
            out.write(header.encode())
        handles = {path: open(path, "rb") for path in paths}
        try:
            for _, path, off, n in entries:
                f = handles[path]
                f.seek(off)
                out.write(f.read(n))
        finally:
            for f in handles.values():
                f.close()


def psum_statistics(values: dict) -> dict:
    """Sum per-host statistics over the pod: one all-reduce of a float64
    CPU tensor, the keys in sorted order (the JAX package's psum over the
    global mesh). One process returns its input."""
    import torch.distributed as dist

    if not dist.is_initialized() or dist.get_world_size() == 1:
        return dict(values)
    keys = sorted(values)
    total = torch.tensor([float(values[k]) for k in keys], dtype=torch.float64)
    dist.all_reduce(total, op=dist.ReduceOp.SUM)
    return {k: float(total[i]) for i, k in enumerate(keys)}


class PodShardedIndex:
    """The strobemer index split across the pod's hosts.

    Each host holds only its contiguous, run-aligned slice of the
    hash-sorted arrays (shard `process_index` of `shard_bounds`, the cut of
    the JAX package's PodShardedIndex, so a key is owned by exactly one
    host), uploaded once to `device` (the card by default; without one
    the device check raises before a port opens). Lookups route on the
    host by hash range. This host's keys are searched and gathered by the
    `ops/shard_cuda.py` pair `find_runs` and `gather_runs` (the kernel
    csrc/find_runs.cu, or its plain versions for CPU tensors) with the
    slice's global start, so positions stay global, against the rows of
    the index's global bucket table that the slice's hashes span. Keys
    owned by another host go to it over a persistent TCP connection, and a
    server thread answers the peers' keys the same way, each connection on
    a CUDA stream of its own.

    The wire protocol is the JAX package's: a request is the header
    ``<qqq`` (nq, cap, opcode 0) and nq uint64 keys; the reply is sparse:
    found u8, gpos i64, count i64 per key, the number of entries (i64),
    then min(count, cap) run positions and packed words (u32 each) per
    found key, in key order. Dialing retries a refused connection for
    ``RSB_POD_CONNECT_TIMEOUT`` seconds (600), and for
    ``RSB_POD_REDIAL_TIMEOUT`` (5) once the owner was reached before; a
    connection that broke mid-frame is evicted and the exchange retried
    once on a fresh one.

    Presents `find_runs_compact` (the lookup `_shard_chunk_a` makes, with
    the return dict of `ShardedIndex.find_runs_compact`), the dense
    `find_runs_routed` of the JAX package (also as `find_runs`, as there),
    `k()` and `close()`."""

    _HDR = "<qqq"  # nq, cap, opcode

    def __init__(self, index, process_index: int, process_count: int, peers: List[str],
                 device="cuda"):
        t0 = time.perf_counter()
        # resolved first: without a card, "cuda" raises before a port opens
        dev = check_devices([device], "the pod index's device")[0]
        hashes = index.hashes
        n = hashes.shape[0]
        bounds = shard_bounds(hashes, process_count)
        lo, hi = int(bounds[process_index]), int(bounds[process_index + 1])
        self.device = dev
        self.start = lo
        self.size = hi - lo  # this host's randstrobes
        self.bits = int(index.bits)
        # copies of the slice (the index arrays may be --mmap-index
        # memmaps, and the caller drops the full ones); an empty slice
        # gets one 0xFF..F entry, as ShardedIndex pads, since find_runs
        # takes no empty shard: with size 0 it answers every key a miss
        if hi > lo:
            h = np.array(hashes[lo:hi], dtype=np.uint64)
            p = np.array(index.positions[lo:hi], dtype=np.uint32)
            k = np.array(index.packed[lo:hi], dtype=np.uint32)
        else:
            h, p, k = np.full(1, SENTINEL), np.zeros(1, np.uint32), np.zeros(1, np.uint32)
        # the bucket table's rows of the slice's top-bits range only, as the
        # JAX package trims it (~2**bits / N rows a host); top0 is the first
        self.top0 = int(h[0]) >> (64 - self.bits) if hi > lo else 0
        top_hi = int(h[-1]) >> (64 - self.bits) if hi > lo else 0
        with _UPLOAD_LOCK:
            self._buckets = _put(np.array(index.randstrobe_start_indices[self.top0:top_hi + 2],
                                          np.uint64).view(np.int64), dev)
            self._h = _put(h.view(np.int64), dev)
            self._p = _put(p.view(np.int32), dev)
            self._k = _put(k.view(np.int32), dev)
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
        self.nbytes = 16 * self.size  # hashes, positions and packed
        # global routing table: owner s covers [start_hash[s],
        # start_hash[s+1]); never route to an empty slice, as 0xFF..F is
        # both a legal hash and the empty-slice marker
        sh = np.full(process_count, SENTINEL, dtype=np.uint64)
        for s in range(process_count):
            if bounds[s] < n:
                sh[s] = hashes[bounds[s]]
        nonempty = bounds[:-1] < bounds[1:]
        self._route_nonempty = np.maximum.accumulate(
            np.where(nonempty, np.arange(process_count), 0))
        self._start_hash = sh
        self.filter_cutoff = int(index.filter_cutoff)
        # the syncmer length (`k()`); a bare index of arrays has none
        self._kparam = index.k() if hasattr(index, "k") else None
        self.pid = process_index
        self.nprocs = process_count
        self._peers = peers
        self._conns = {}
        self._ever_connected = {}  # per owner: redial fast after a death
        self._io_locks = {}
        self._conn_lock = threading.Lock()
        self._pool = None  # the remote fan-out executor, made on first use
        self._served = {}  # accepted connection -> its thread, ended by close()
        self._stats_lock = threading.Lock()
        # the JAX package's traffic counters, and two wall times: the
        # remote exchanges as this host waited for them, and the lookups
        # this host's server answered (receipt of the keys to the reply)
        self.stats = {"lookup_batches": 0, "lookup_keys": 0,
                      "remote_batches": 0, "remote_keys": 0,
                      "tx_bytes": 0, "rx_bytes": 0, "remote_s": 0.0, "served_s": 0.0}
        host, port = peers[process_index].rsplit(":", 1)
        srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        srv.bind((host, int(port)))
        srv.listen(process_count)
        self._srv = srv
        self._server = threading.Thread(target=self._serve, daemon=True,
                                        name=f"pod-index-server-{process_index}")
        self._server.start()
        self.build_s = time.perf_counter() - t0

    def k(self) -> int:
        return self._kparam

    # --- this host's slice --------------------------------------------

    def _lookup_sparse(self, keys: np.ndarray, cap: int):
        """Search and gather this host's slice for `keys` (uint64) on its
        device. Returns numpy (found u8, gpos i64, count i64, ent_p u32,
        ent_k u32): ent_p and ent_k hold min(count, cap) run rows per found
        key, in key order, the sparse form of the wire reply."""
        nq = keys.shape[0]
        if nq == 0:
            e = np.zeros(0, np.uint32)
            return np.zeros(0, np.uint8), np.zeros(0, np.int64), np.zeros(0, np.int64), e, e
        gpos, count = shard_cuda.find_runs(self._h, self.size, self.start, self._buckets,
                                           self.bits, _put(keys.view(np.int64), self.device),
                                           self.top0)
        width = count.clamp(max=cap)
        ends = torch.cumsum(width, 0)
        n_rows = int(ends[-1])
        ent_p = torch.zeros(max(n_rows, 1), dtype=torch.int32, device=self.device)
        ent_k = torch.zeros_like(ent_p)
        shard_cuda.gather_runs(self._p, self._k, gpos, count, self.start, cap, ends - width,
                               ent_p, ent_k)
        # .cpu() waits for this thread's stream: the reply leaves the host
        # only once the device has written it
        count = count.cpu().numpy()
        return ((count > 0).astype(np.uint8), gpos.cpu().numpy(), count,
                ent_p[:n_rows].cpu().numpy().view(np.uint32),
                ent_k[:n_rows].cpu().numpy().view(np.uint32))

    # --- wire protocol --------------------------------------------------

    def _serve(self) -> None:
        while True:
            try:
                conn, _ = self._srv.accept()
            except OSError:
                return
            t = threading.Thread(target=self._serve_conn, args=(conn,), daemon=True,
                                 name="pod-index-conn")
            with self._conn_lock:
                self._served[conn] = t
            t.start()

    @staticmethod
    def _recv_exact(conn, nbytes: int) -> bytearray:
        buf = bytearray()
        while len(buf) < nbytes:
            part = conn.recv(nbytes - len(buf))
            if not part:
                raise ConnectionError("pod lookup peer closed")
            buf += part
        return buf

    @contextlib.contextmanager
    def _own_stream(self):
        """A CUDA stream of this thread's own on the slice's card; nothing
        on the CPU."""
        if self.device.type != "cuda":
            yield
            return
        with torch.cuda.device(self.device), torch.cuda.stream(torch.cuda.Stream(self.device)):
            yield

    def _serve_conn(self, conn) -> None:
        hsz = struct.calcsize(self._HDR)
        try:
            with self._own_stream():
                while True:
                    nq, cap, _op = struct.unpack(self._HDR, self._recv_exact(conn, hsz))
                    keys = np.frombuffer(self._recv_exact(conn, 8 * nq), dtype=np.uint64)
                    t0 = time.perf_counter()
                    found, gpos, count, ent_p, ent_k = self._lookup_sparse(keys, cap)
                    reply = (found.tobytes() + gpos.tobytes() + count.tobytes()
                             + struct.pack("<q", ent_p.shape[0]) + ent_p.tobytes()
                             + ent_k.tobytes())
                    # counted before the reply leaves: a requester holding
                    # its answer reads this lookup's time
                    with self._stats_lock:
                        self.stats["served_s"] += time.perf_counter() - t0
                    conn.sendall(reply)
        except (ConnectionError, OSError):
            pass
        finally:
            # also on a server-side error: a closed socket makes the
            # requester's recv raise instead of waiting mid-frame
            conn.close()

    def _connect(self, owner: int):
        """Dial a peer, retrying a refused connection: hosts reach this
        object's construction at different times, so a fast host's first
        lookup can precede a slow host's bind. RSB_POD_CONNECT_TIMEOUT
        seconds (600) to reach an owner for the first time;
        RSB_POD_REDIAL_TIMEOUT (5) once it was reached, when a refusal
        means it died."""
        host, port = self._peers[owner].rsplit(":", 1)
        budget = float(os.environ.get("RSB_POD_CONNECT_TIMEOUT", "600"))
        if self._ever_connected.get(owner):
            budget = min(budget, float(os.environ.get("RSB_POD_REDIAL_TIMEOUT", "5")))
        deadline = time.monotonic() + budget
        while True:
            try:
                conn = socket.create_connection((host, int(port)), timeout=120)
                self._ever_connected[owner] = True
                return conn
            except ConnectionRefusedError:
                if time.monotonic() >= deadline:
                    raise
                time.sleep(0.2)

    def _remote(self, owner: int, keys: np.ndarray, cap: int):
        """One request/response exchange with `owner`: the sparse reply of
        `_lookup_sparse`. The per-owner lock spans the whole exchange
        (callers of several threads would otherwise read each other's
        frames), and the connection is looked up after taking it, so a
        caller queued behind a failed exchange redials."""
        with self._conn_lock:
            io_lock = self._io_locks.setdefault(owner, threading.Lock())
        t0 = time.perf_counter()
        with io_lock:
            for attempt in (0, 1):
                with self._conn_lock:
                    conn = self._conns.get(owner)
                if conn is None:
                    conn = self._connect(owner)
                    with self._conn_lock:
                        self._conns[owner] = conn
                try:
                    nq = keys.shape[0]
                    conn.sendall(struct.pack(self._HDR, nq, cap, 0) + keys.tobytes())
                    found = np.frombuffer(self._recv_exact(conn, nq), np.uint8)
                    gpos = np.frombuffer(self._recv_exact(conn, 8 * nq), np.int64)
                    count = np.frombuffer(self._recv_exact(conn, 8 * nq), np.int64)
                    (tot,) = struct.unpack("<q", self._recv_exact(conn, 8))
                    if not 0 <= tot <= nq * cap:
                        # a desynced stream (leftovers of a failed
                        # exchange): handled as a socket error
                        raise ConnectionError(f"pod lookup response desynced (tot={tot}, "
                                              f"nq={nq}, cap={cap})")
                    ent_p = np.frombuffer(self._recv_exact(conn, 4 * tot), np.uint32)
                    ent_k = np.frombuffer(self._recv_exact(conn, 4 * tot), np.uint32)
                    with self._stats_lock:
                        self.stats["remote_batches"] += 1
                        self.stats["remote_keys"] += nq
                        self.stats["tx_bytes"] += 24 + 8 * nq
                        self.stats["rx_bytes"] += 17 * nq + 8 + 8 * tot
                        self.stats["remote_s"] += time.perf_counter() - t0
                    return found, gpos, count, ent_p, ent_k
                except (ConnectionError, OSError):
                    # the stream is mid-frame: evict the socket and retry
                    # once on a fresh connection
                    self._evict(owner, conn)
                    if attempt:
                        raise
                except BaseException:
                    # any other failure leaves the stream desynced too
                    self._evict(owner, conn)
                    raise

    def _evict(self, owner: int, conn) -> None:
        with self._conn_lock:
            if self._conns.get(owner) is conn:
                del self._conns[owner]
        try:
            conn.close()
        except OSError:
            pass

    def _fanout(self) -> ThreadPoolExecutor:
        """The executor that queries the remote owners concurrently, made
        on first use."""
        with self._conn_lock:
            if self._pool is None:
                self._pool = ThreadPoolExecutor(
                    max_workers=min(32, max(1, (self.nprocs - 1) * 4)),
                    thread_name_prefix="pod-fanout")
            return self._pool

    # --- the lookup interface --------------------------------------------

    def _routed_parts(self, keys: np.ndarray, cap: int):
        """[(indices of the keys an owner holds, its sparse answer)]: the
        remote owners queried concurrently, before this host's own lookup
        runs, so the wire wait overlaps it."""
        nq = keys.shape[0]
        with self._stats_lock:
            self.stats["lookup_batches"] += 1
            self.stats["lookup_keys"] += nq
        owner = np.searchsorted(self._start_hash, keys, side="right") - 1
        np.clip(owner, 0, self.nprocs - 1, out=owner)
        owner = self._route_nonempty[owner]
        pending = []
        for s in range(self.nprocs):
            sel = np.flatnonzero(owner == s)
            if s != self.pid and sel.size:
                pending.append((sel, self._fanout().submit(
                    self._remote, s, np.ascontiguousarray(keys[sel]), cap)))
        sel0 = np.flatnonzero(owner == self.pid)
        parts = [(sel0, self._lookup_sparse(np.ascontiguousarray(keys[sel0]), cap))] \
            if sel0.size else []
        return parts + [(sel, fut.result()) for sel, fut in pending]

    @staticmethod
    def _rows(count, cap):
        """For sparse answers: each key's first row and its number of rows."""
        n = np.minimum(count, cap)
        return np.cumsum(n) - n, n

    def find_runs_routed(self, keys: np.ndarray, cap: int) -> dict:
        """The dense lookup of the JAX package's PodShardedIndex: position
        (global first index, -1 if absent), count, filtered, and the first
        min(count, cap) run rows of each key in (NQ, cap) planes."""
        keys = np.ascontiguousarray(np.asarray(keys, dtype=np.uint64))
        nq = keys.shape[0]
        found = np.zeros(nq, np.uint8)
        gpos = np.zeros(nq, np.int64)
        count = np.zeros(nq, np.int64)
        runp = np.zeros((nq, cap), np.uint32)
        runk = np.zeros((nq, cap), np.uint32)
        for sel, (f, g, c, ep, ek) in self._routed_parts(keys, cap):
            found[sel], gpos[sel], count[sel] = f, g, c
            first, n = self._rows(c, cap)
            row = np.repeat(sel, n)
            col = np.arange(int(n.sum())) - np.repeat(first, n)
            runp[row, col] = ep
            runk[row, col] = ek
        return {
            "position": np.where(found > 0, gpos, -1).astype(np.int64),
            "count": count,
            "filtered": count > self.filter_cutoff,
            "run_positions": runp,
            "run_packed": runk,
        }

    find_runs = find_runs_routed

    def find_runs_compact(self, keys: np.ndarray, cap: Optional[int] = None) -> dict:
        """The routed lookup in the layout of `ShardedIndex.find_runs_compact`:
        count (NQ,) int64; filtered (NQ,) bool; run_off (NQ,) int64, the
        first record of each walked key (found, count <= cap; cap defaults
        to the filter cutoff), -1 for the others; run_positions and
        run_packed (R,) uint32, the walked keys' records back to back in key
        order (one zero row if none). Equal to compacting
        `find_runs_routed(keys, cap)`."""
        cap = self.filter_cutoff if cap is None else int(cap)
        keys = np.ascontiguousarray(np.asarray(keys, dtype=np.uint64))
        nq = keys.shape[0]
        parts = self._routed_parts(keys, cap)
        count = np.zeros(nq, np.int64)
        for sel, (_, _, c, _, _) in parts:
            count[sel] = c
        walk = (count > 0) & (count <= cap)
        width = np.where(walk, count, 0)
        ends = np.cumsum(width)
        run_off = np.where(walk, ends - width, -1)
        n_rows = int(ends[-1]) if nq else 0
        run_pos = np.zeros(max(n_rows, 1), np.uint32)
        run_packed = np.zeros_like(run_pos)
        for sel, (_, _, c, ep, ek) in parts:
            first, n = self._rows(c, cap)
            keep = walk[sel] & (n > 0)
            src = np.repeat(first[keep], n[keep])
            dst = np.repeat(run_off[sel][keep], n[keep])
            step = np.arange(src.shape[0]) - np.repeat(np.cumsum(n[keep]) - n[keep], n[keep])
            run_pos[dst + step] = ep[src + step]
            run_packed[dst + step] = ek[src + step]
        return {
            "count": count,
            "filtered": count > self.filter_cutoff,
            "run_off": run_off,
            "run_positions": run_pos,
            "run_packed": run_packed,
        }

    def close(self) -> None:
        """Stop serving and close every connection and the listening
        socket (shutdown first: a plain close does not wake a thread
        blocked in accept)."""
        for fn in (lambda: self._srv.shutdown(socket.SHUT_RDWR), self._srv.close):
            try:
                fn()
            except OSError:
                pass
        self._server.join(timeout=5.0)
        with self._conn_lock:
            pool, self._pool = self._pool, None
            conns = list(self._conns.values()) + list(self._served)
            threads = list(self._served.values())
            self._conns.clear()
            self._served.clear()
        if pool is not None:
            pool.shutdown(wait=False)
        for c in conns:
            try:
                c.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            c.close()
        for t in threads:
            t.join(timeout=5.0)

