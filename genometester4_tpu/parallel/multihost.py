"""Multi-host (multi-process) k-mer counting over a global device mesh.

The reference is strictly single-node (SURVEY.md §2c: pthreads only, no
MPI/NCCL/sockets). Its scale-out story ends at one machine; this module
is the cross-host half of the mesh design (SURVEY.md §5 "Distributed
communication backend", §2g): multiple processes — one per GPU host, or
N CPU processes in tests — form one global ``("dp", "kp")`` mesh via
``jax.distributed`` and run the *same* SPMD counting program as the
single-process mesh path (parallel/sharding.py), unchanged:

  dp  — the PROCESS axis. Row i of the mesh is exactly host i's local
        devices, so the one cross-row collective (the all_gather that
        merges per-shard partial counts) is the only traffic that
        crosses the host network — and it moves already-deduplicated
        (word, count) buckets, orders of magnitude smaller than the raw
        window stream.
  kp  — each host's local cards. The all_to_all prefix exchange (the
        bandwidth-heavy collective) stays on the host's all-to-all
        NVLink.

Word-space sharding is by MOST significant bits (sharding._owner_shard),
so shard-major concatenation of per-kp results is globally sorted and
the final ``.list`` bytes are identical to the single-device and
single-process runs at every (process count × local device count) shape
— the multi-host generalization of the invariant the reference gets
from its tmp-file k-way merge (src/set-operations.c:40-129).

Ingestion: every process parses the shared input (hosts of a cluster see
the same filesystem) but only UPLOADS its own row's chunk share, so
device work and collective traffic scale with 1/n_processes. Host-side
parse is duplicated; it is a few percent of wall time on the measured
pipelines and keeping it replicated makes step counts and overflow
retries trivially agree across processes (every process sees identical
control flow — a requirement for collectives).

Activation: environment-driven, mirroring how clusters launch one process
per host::

    GT4_DIST_COORD=host0:9999 GT4_DIST_NPROCS=4 GT4_DIST_PROC_ID=i \
        glistmaker reads.fa -w 25 -o out

pipelines.listmaker.make_list hosts the distributed run (so spill,
cutoffs, and -D accounting are the single code path): non-writer
processes participate in every collective but accumulate nothing;
process 0 merges and writes; a cross-process barrier makes every
process return only after the file is published. tests/test_multihost.py
drives real multi-process runs (Gloo collectives over loopback stand in
for the host network) and byte-compares against the reference binary.
"""

from __future__ import annotations

import math
import os

import numpy as np

from genometester4_tpu.utils.lazyjax import jax, jnp, jax_sharding


_initialized = False


def distributed_env():
    """The (coord, nprocs, proc_id) triple from GT4_DIST_* env, or None."""
    coord = os.environ.get("GT4_DIST_COORD")
    if not coord:
        return None
    nprocs = int(os.environ.get("GT4_DIST_NPROCS", "1"))
    proc_id = int(os.environ.get("GT4_DIST_PROC_ID", "0"))
    if nprocs <= 1:
        return None
    return coord, nprocs, proc_id


def init_from_env() -> bool:
    """Join the process group described by GT4_DIST_* (idempotent).

    Returns True when this process is part of a >1-process group."""
    global _initialized
    env = distributed_env()
    if env is None:
        return False
    if not _initialized:
        coord, nprocs, proc_id = env
        jax.distributed.initialize(coordinator_address=coord,
                                   num_processes=nprocs,
                                   process_id=proc_id)
        _initialized = True
    return jax.process_count() > 1


def is_multiprocess() -> bool:
    """True when a multi-process group is configured AND joinable.

    Cheap when GT4_DIST_COORD is unset (no jax import)."""
    if distributed_env() is None:
        return False
    return init_from_env()


def make_global_mesh():
    """("dp", "kp") mesh with one dp row per process.

    Devices are ordered (process_index, id) so row i is host i's local
    chips: the kp all_to_all stays inside a host, the dp all_gather is
    the only cross-host collective (module docstring)."""
    from genometester4_tpu.parallel.sharding import Mesh

    nproc = jax.process_count()
    devs = sorted(jax.devices(), key=lambda d: (d.process_index, d.id))
    local = len(devs) // nproc
    arr = np.array(devs).reshape(nproc, local)
    return Mesh(arr, ("dp", "kp"))


def make_flat_global_mesh(axis: str = "sp"):
    """A flat 1-axis mesh over every device in the process group,
    process-major (host i's chips are contiguous), for SPMD programs
    whose only cross-device traffic is an all_gather/psum of small
    per-bucket results (set ops, DB counting)."""
    from genometester4_tpu.parallel.sharding import Mesh

    devs = sorted(jax.devices(), key=lambda d: (d.process_index, d.id))
    return Mesh(np.array(devs), (axis,))


def put_axis0_sharded(arr: np.ndarray, mesh, axis: str = "sp"):
    """Place a [n_dev, ...] host array sharded over a flat mesh's axis 0.

    Each process uploads ONLY the rows that live on its own devices;
    every process holds the identical full host array (they all parsed
    the same shared inputs), so no host bytes cross processes."""
    P = jax_sharding.PartitionSpec
    spec = P(axis, *([None] * (arr.ndim - 1)))
    sharding = jax_sharding.NamedSharding(mesh, spec)
    pid = jax.process_index()
    arrs = []
    for i, dev in enumerate(mesh.devices.reshape(-1)):
        if dev.process_index == pid:
            arrs.append(jax.device_put(arr[i:i + 1], dev))
    return jax.make_array_from_single_device_arrays(arr.shape, sharding,
                                                    arrs)


def put_replicated(arr: np.ndarray, mesh):
    """Place a host array replicated on every device of the mesh; each
    process uploads to its own devices only."""
    P = jax_sharding.PartitionSpec
    sharding = jax_sharding.NamedSharding(mesh, P())
    pid = jax.process_index()
    arrs = [jax.device_put(arr, d) for d in mesh.devices.reshape(-1)
            if d.process_index == pid]
    return jax.make_array_from_single_device_arrays(arr.shape, sharding,
                                                    arrs)


def barrier(tag: str) -> None:
    """Cross-process barrier (writer publishes before anyone returns)."""
    from jax.experimental import multihost_utils
    multihost_utils.sync_global_devices(tag)


def _put_global_blocks(blocks: np.ndarray, mesh):
    """Place a [dp, kp, chunk] host array as a global jax.Array.

    Each process uploads ONLY its own mesh row (its local devices);
    other rows' host bytes are never transferred by this process."""
    P = jax_sharding.PartitionSpec
    sharding = jax_sharding.NamedSharding(mesh, P("dp", "kp", None))
    pid = jax.process_index()
    arrs = []
    for i in range(mesh.devices.shape[0]):
        for j in range(mesh.devices.shape[1]):
            dev = mesh.devices[i, j]
            if dev.process_index == pid:
                arrs.append(jax.device_put(blocks[i:i + 1, j:j + 1], dev))
    return jax.make_array_from_single_device_arrays(
        blocks.shape, sharding, arrs)


def _fetch_sharded(arr) -> np.ndarray:
    """Assemble a host copy of an axis-0-sharded global array.

    Valid whenever every shard is addressable from this process — true
    for the counting step's outputs, which are sharded over kp and
    replicated over dp, so each process's row holds all kp shards."""
    out = np.empty(arr.shape, arr.dtype)
    for s in arr.addressable_shards:
        out[s.index] = np.asarray(s.data)
    return out


def iter_count_kmers_multihost(codes: np.ndarray, k: int, mesh,
                               chunk_bases: int | None = None,
                               cap_factor: int | None = None,
                               adapt_state: dict | None = None):
    """Multi-process twin of sharding.iter_count_kmers_sharded.

    ``codes`` is the full packed code array (every process parses the
    shared input); each step feeds dp*kp chunks globally, of which this
    process uploads only its kp-row share. Yields the globally sorted
    (words, counts) bucket stream — identical on every process, since
    the per-kp-shard results are dp-replicated by the step's all_gather.
    """
    from genometester4_tpu.ops.encode import join_u64
    from genometester4_tpu.parallel.sharding import (CAP_FACTOR,
                                                     sharded_count_step)
    from genometester4_tpu.pipelines.listmaker import merge_sorted_shards

    # None/"auto": duplication-adaptive slack, same policy as
    # sharding.iter_count_kmers_sharded (shrink to observed peak fill
    # x1.5 with 1.3x hysteresis; overflow retry covers under-estimates)
    auto = cap_factor is None or cap_factor == "auto"
    if auto:
        cap_factor = (adapt_state or {}).get("cap_factor", CAP_FACTOR)
    dp = mesh.shape["dp"]
    kp = mesh.shape["kp"]
    n_dev = dp * kp
    pid = jax.process_index()
    if chunk_bases is None:
        chunk_bases = max(1 << 14, (len(codes) // n_dev + k))
        chunk_bases = 1 << math.ceil(math.log2(chunk_bases))
    fn, _ = sharded_count_step(mesh, k, chunk_bases, cap_factor)

    step = chunk_bases - (k - 1)
    starts = list(range(0, max(len(codes) - (k - 1), 1), step))
    shard_results = []
    for gi in range(0, len(starts), n_dev):
        batch = starts[gi:gi + n_dev]
        blocks = np.full((n_dev, chunk_bases), 255, np.uint8)
        # fill only this process's dp row (rows are contiguous spans of
        # the flat chunk batch: chunk index = dp_row * kp + kp_col)
        for bi, s in enumerate(batch):
            if bi // kp != pid and dp > 1:
                continue
            chunk = codes[s:s + chunk_bases]
            blocks[bi, : len(chunk)] = chunk
        blocks = blocks.reshape(dp, kp, chunk_bases)
        garr = _put_global_blocks(blocks, mesh)
        hi, lo, cnt, n_uniq, ovf, mf = fn(garr)
        while int(np.asarray(jax.device_get(ovf))):
            cap_factor *= 2
            fn, _ = sharded_count_step(mesh, k, chunk_bases, cap_factor)
            hi, lo, cnt, n_uniq, ovf, mf = fn(garr)
        if auto:
            want = 1.5 * max(int(np.asarray(jax.device_get(mf))), 1) \
                / max(1, (chunk_bases - k + 1) // kp)
            if want < cap_factor / 1.3:
                cap_factor = max(want, 0.02)
                fn, _ = sharded_count_step(mesh, k, chunk_bases,
                                           cap_factor)
            if adapt_state is not None:
                adapt_state["cap_factor"] = cap_factor
        hi = _fetch_sharded(hi)
        lo = _fetch_sharded(lo)
        cnt = _fetch_sharded(cnt)
        n_uniq = _fetch_sharded(n_uniq)
        shard_results.append([
            (join_u64(hi[s, : n_uniq[s]], lo[s, : n_uniq[s]]),
             cnt[s, : n_uniq[s]].astype(np.uint32))
            for s in range(kp)])

    for s in range(kp):
        per_shard = [res[s] for res in shard_results]
        yield from merge_sorted_shards(per_shard)


