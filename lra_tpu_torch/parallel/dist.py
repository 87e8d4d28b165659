"""Multi-process / multi-host execution.

Reads are embarrassingly parallel, so the cross-host story mirrors the
reference's only multi-node mechanism — ``--start/--stride`` read-index
sharding (reference: lra.cpp:110-112,227-234) — made first-class:

* ``init_process(nproc, procid, ...)`` turns one CLI invocation into
  process ``procid`` of ``nproc``: it aligns reads procid, procid+nproc,
  ... and writes ``{out}.shard{procid}``.  With a coordinator address it
  also joins a ``torch.distributed`` process group (gloo, TCP rendezvous
  at the coordinator), torn down at exit: the processes of a multi-host
  run find each other, but no collective runs — kernel batches stay
  process-local, and the genome/index stay replicated per process,
  exactly like the reference's independent jobs.
* ``merge_shards`` reconstructs the single-process SAM byte-for-byte
  *modulo the @PG header line* (which embeds the per-process command
  line): header from shard 0, then per-read record groups interleaved
  round-robin (shard ``k % nproc`` owns read ``k``).  Group boundaries
  are QNAME changes, so the aligner rejects inputs whose shard would
  place two same-named reads back to back (see cli.gen_batches).
"""

from __future__ import annotations


def init_process(nproc: int, procid: int, out: str,
                 coordinator: str = ""):
    """Returns (start, stride, shard_out_path) for this process."""
    if not (0 <= procid < nproc):
        raise ValueError(f"procid {procid} not in [0, {nproc})")
    if nproc > 1 and out == "-":
        # every process writing SAM to its own stdout leaves nothing for
        # `lra_tpu merge` and fails silently — require a real path
        raise ValueError(
            "--nproc > 1 needs an explicit -o FILE (each process writes "
            "FILE.shardN; merge with `lra_tpu merge`)")
    if coordinator:
        import atexit

        import torch.distributed as dist

        dist.init_process_group("gloo", init_method=f"tcp://{coordinator}",
                                world_size=nproc, rank=procid)
        atexit.register(dist.destroy_process_group)
    shard_out = out if out == "-" else f"{out}.shard{procid}"
    return procid, nproc, shard_out


def _group_iter(f):
    """Yield per-read record groups from an open SAM file (records of
    one read are written consecutively; QNAME marks the boundary)."""
    cur_name = None
    group: list = []
    for ln in f:
        ln = ln.rstrip("\n")
        if not ln or ln.startswith("@"):
            continue
        name = ln.split("\t", 1)[0]
        if name != cur_name and group:
            yield group
            group = []
        cur_name = name
        group.append(ln)
    if group:
        yield group


def merge_shards(shard_paths: list, out_file) -> int:
    """Merge stride-sharded SAM files back into single-process order.

    Streaming: one record group per shard is in memory at a time, so
    multi-GB shards merge in O(1) memory.  shard_paths must be ordered
    by procid; a wrong order or a missing shard is detected after the
    fact via the round-robin count invariant.  Returns #reads merged."""
    from contextlib import ExitStack

    nproc = len(shard_paths)
    with open(shard_paths[0]) as f0:
        for ln in f0:
            if not ln.startswith("@"):
                break
            out_file.write(ln if ln.endswith("\n") else ln + "\n")
    n = 0
    counts = [0] * nproc
    with ExitStack() as stack:
        iters = [_group_iter(stack.enter_context(open(p)))
                 for p in shard_paths]
        done = [False] * nproc
        remaining = nproc
        k = 0
        while remaining:
            s = k % nproc
            if not done[s]:
                group = next(iters[s], None)
                if group is None:
                    done[s] = True
                    remaining -= 1
                else:
                    for ln in group:
                        out_file.write(ln + "\n")
                    counts[s] += 1
                    n += 1
            k += 1
    # round-robin invariant: shard s holds reads s, s+nproc, ... so
    # counts must be non-increasing with count[0]-count[last] <= 1;
    # a violation means shards were passed out of procid order or one
    # is truncated/missing
    if any(counts[s] < counts[s + 1] for s in range(nproc - 1)) or \
            (nproc > 1 and counts[0] - counts[-1] > 1):
        raise ValueError(
            f"shard read counts {counts} violate the round-robin "
            "invariant — shards out of procid order, or a shard is "
            "missing/truncated; pass FILE.shard0 FILE.shard1 ... in order")
    return n
