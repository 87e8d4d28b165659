"""Set-up, the measured window and the traced records of one run.

The system under test is ``lra_tpu_torch.pipeline.stream.align_stream``
(the path of ``lra align -t N``), fed batches of simulated reads in a
closed loop: align_stream pulls the next batch whenever fewer than
workers + 1 are in flight, so a slower system is offered less.  The
benchmark takes from the program only that entry, its index builders,
its stage timer (``utils/timing.Timing``), its device-round statistics
(``utils/devstats``) and the kernel wrappers' names, around which it
puts its own shim (``Capture``).
"""

from __future__ import annotations

import glob
import hashlib
import importlib
import json
import os
import re
import subprocess
import sys
import threading
import time

import numpy as np

from bench_port import registry
from bench_port.gen.genome import make_genome
from bench_port.gen.reads import length_quantiles, make_reads

CACHE = os.path.join(registry.HERE, ".cache")
POOL, WARM, SAMPLE, CAPTURE = 1, 2, 3, 4     # purposes of the seed's streams


def log(*a) -> None:
    print("bench_port:", *a, file=sys.stderr, flush=True)


def rng_for(seed: int, purpose: int) -> np.random.Generator:
    """An independent stream of ``seed`` (any integer) for one purpose."""
    return np.random.default_rng([abs(int(seed)), int(seed < 0), purpose])


# ----------------------------------------------------------- set-up ---

def _index_key(cfg: dict) -> str:
    """The index cache's key: the preset, the genome recipe and the
    sources that build an index."""
    h = hashlib.sha256(json.dumps([cfg["preset"], cfg["genome"]],
                                  sort_keys=True).encode())
    port = os.path.join(registry.ROOT, "lra_tpu_torch")
    paths = sorted(glob.glob(os.path.join(port, "index", "*.py"))) + [
        os.path.join(port, f) for f in ("options.py", "seq.py",
                                        "io/genome.py")]
    paths += sorted(glob.glob(os.path.join(port, "native", "*.cpp")))
    for p in paths:
        with open(p, "rb") as f:
            h.update(f.read())
    return h.hexdigest()[:16]


def _build_index(cfg: dict, genome, opts, threads: int = 1):
    from lra_tpu_torch.index.global_index import build_global_index
    from lra_tpu_torch.index.local_index import build_genome_local_index

    gi = build_global_index(genome, opts, threads=threads)
    li = build_genome_local_index(genome, k=min(opts.local_k, 10),
                                  w=opts.local_w,
                                  window=opts.local_index_window,
                                  max_freq=opts.local_max_freq,
                                  threads=threads,
                                  exact=opts.exact_ref_minimizers)
    return gi, li


def load_index(cfg: dict, genome, opts, cache: bool = True):
    """(global index, genome local index, found in the cache), as ``lra
    index`` then ``lra align`` would have them.  With ``cache``, a child
    process builds a missing index into the checkout's cache (so that no
    run's window shares a process with an index build) and every run
    loads it from there."""
    from lra_tpu_torch.index.global_index import GlobalIndex
    from lra_tpu_torch.index.local_index import LocalIndex

    if not cache:
        return (*_build_index(cfg, genome, opts), False)
    stem = os.path.join(CACHE, "index", f"{cfg['name']}-{_index_key(cfg)}")
    found = os.path.exists(stem + ".gdx.npz") and \
        os.path.exists(stem + ".ldx.npz")
    if not found:
        subprocess.run([sys.executable, "-m", "bench_port.harness",
                        json.dumps(cfg), stem], cwd=registry.ROOT,
                       check=True)
        os.sync()          # the files' writeback ends before the window
    return (GlobalIndex.load(stem + ".gdx.npz"),
            LocalIndex.load(stem + ".ldx.npz"), found)


def _save_index(cfg: dict, stem: str) -> None:
    """Build the index of ``cfg``'s genome and store it at ``stem``."""
    from lra_tpu_torch import preset
    from lra_tpu_torch.io.genome import Genome

    names, seqs, _reps = make_genome(cfg["genome"])
    genome = Genome.from_seqs(list(zip(names, seqs)))
    gi, li = _build_index(cfg, genome, preset(cfg["preset"]),
                          threads=min(8, os.cpu_count() or 1))
    os.makedirs(os.path.dirname(stem), exist_ok=True)
    for old in glob.glob(os.path.join(CACHE, "index", f"{cfg['name']}-*")):
        os.remove(old)
    tmp = f"{stem}.tmp{os.getpid()}"
    gi.save(tmp + "g.npz")
    li.save(tmp + "l.npz")
    os.replace(tmp + "g.npz", stem + ".gdx.npz")
    os.replace(tmp + "l.npz", stem + ".ldx.npz")


class Setup:
    """Everything a run builds before its window: the genome, the index,
    the read pool and the warm-up batches."""

    def __init__(self, cfg: dict, traffic: dict, seed: int, device: str,
                 cache: bool = True):
        from lra_tpu_torch import preset
        from lra_tpu_torch.io.genome import Genome

        self.cfg, self.traffic, self.seed, self.device = \
            cfg, traffic, seed, device
        self.opts = preset(cfg["preset"])
        # the preset's scoring, which the output check holds the kernels to
        self.scoring = {k: getattr(self.opts, k) for k in (
            "local_match", "local_mismatch", "local_indel", "gap_extend",
            "gap_root", "gap_ceiling1", "gap_ceiling2")}
        t = time.perf_counter()
        self.names, self.seqs, self.repeats = make_genome(cfg["genome"])
        self.genome = Genome.from_seqs(list(zip(self.names, self.seqs)))
        self.gi, self.li, self.index_cached = load_index(
            cfg, self.genome, self.opts, cache)
        log(f"genome and index ({'cached' if self.index_cached else 'built'})"
            f" in {time.perf_counter() - t:.1f} s")
        t = time.perf_counter()
        per = int(traffic["batch_reads"])
        self.pool = self._batches(int(cfg["pool_batches"]), per,
                                  rng_for(seed, POOL), "r")
        self.warm = self._batches(int(traffic["warm_batches"]), per,
                                  rng_for(seed, WARM), "w")
        log(f"{len(self.pool)} batches of {per} reads "
            f"({sum(len(r.codes) for b in self.pool for r in b)} bases) and "
            f"{len(self.warm)} warm-up batches in "
            f"{time.perf_counter() - t:.1f} s")

    def _batches(self, n: int, per: int, rng, prefix: str) -> list:
        """n batches of ``per`` reads; every batch holds the same lengths
        (the profile's ``per`` quantiles), each in an order of its own, so
        that a window of any seed holds the same work per batch."""
        grid = length_quantiles(self.cfg["reads"], per)
        lengths = np.concatenate([grid[rng.permutation(per)]
                                  for _ in range(n)])
        reads = make_reads(rng, self.seqs, lengths, self.cfg["reads"],
                           prefix)
        return [reads[k:k + per] for k in range(0, n * per, per)]

    def stream(self, batches, timing=None):
        from lra_tpu_torch.pipeline.stream import align_stream

        return align_stream(([(r.name, r.codes) for r in b] for b in batches),
                            self.genome, self.gi, self.opts,
                            genome_li=self.li, timing=timing,
                            workers=int(self.traffic["workers"]),
                            device=self.device)

    def warm_up(self) -> None:
        for _ in self.stream(self.warm):
            pass


# ------------------------------------------------------------ window ---

class Window:
    """The closed loop: batches of the pool, in order (wrapping round if
    the pool runs out), submitted until ``seconds`` have passed since the
    first submission, then the batches in flight drained."""

    def __init__(self, setup: Setup, seconds: float, timing=None):
        self.setup, self.seconds, self.timing = setup, seconds, timing
        self.pulled: list = []       # host time align_stream took batch k
        self.done: list = []         # host time batch k's lines came back
        self.lines: list = []        # batch k's SAM lines
        self.batches: list = []      # batch k's reads
        self.wrapped = False

    def _feed(self):
        pool = self.setup.pool
        k = 0
        while True:
            now = time.perf_counter()
            if self.pulled and now - self.pulled[0] >= self.seconds:
                return
            if k == len(pool) and not self.wrapped:
                self.wrapped = True
                log(f"the pool of {len(pool)} batches ran out: the window "
                    "wraps round it")
            batch = pool[k % len(pool)]
            self.pulled.append(now)
            self.batches.append(batch)
            yield batch
            k += 1

    def run(self) -> None:
        for _states, lines in self.setup.stream(self._feed(), self.timing):
            self.done.append(time.perf_counter())
            self.lines.append(lines)

    @property
    def t0(self) -> float:
        return self.pulled[0]

    @property
    def wall(self) -> float:
        return self.done[-1] - self.pulled[0]

    def bases(self) -> int:
        return sum(len(r.codes) for b in self.batches for r in b)

    def latencies_ms(self) -> np.ndarray:
        return 1e3 * (np.array(self.done) - np.array(self.pulled))


# ------------------------------------------------------------ shim ---

def _work(args) -> int:
    a = args[0]
    return int(a.numel() if hasattr(a, "numel") else np.size(a))


class Capture:
    """A shim around the kernel wrappers that roofline/ names, at the
    sites through which the program calls them.  While ``on``, each call
    is counted; a reservoir of ``keep`` calls per kernel, drawn with
    ``rng``, and the largest call are kept for the output check, and with
    ``keep_all`` every call (its arguments and outputs, by reference: no
    copy, no wait) for the rooflines."""

    def __init__(self, kernels: dict, rng, keep: int = 4,
                 keep_all: bool = False):
        self.kernels, self.rng, self.keep = kernels, rng, keep
        self.keep_all = keep_all
        self.on = False
        self.calls = {k: 0 for k in kernels}
        self.sample = {k: [] for k in kernels}
        self.largest: dict = {}
        self.all: list = []
        self._lock = threading.Lock()
        self._saved: list = []

    def __enter__(self):
        for name, mod in self.kernels.items():
            for mod_name, attr in mod.SITES:
                m = importlib.import_module(mod_name)
                orig = getattr(m, attr)
                self._saved.append((m, attr, orig))
                setattr(m, attr, self._wrap(name, orig))
        return self

    def __exit__(self, *exc):
        for m, attr, orig in reversed(self._saved):
            setattr(m, attr, orig)
        self._saved = []
        return False

    def _wrap(self, name, orig):
        def call(*args, **kw):
            out = orig(*args, **kw)
            if self.on:
                rec = (args, kw, out)
                with self._lock:
                    self.calls[name] += 1
                    n = self.calls[name]
                    s = self.sample[name]
                    if len(s) < self.keep:
                        s.append(rec)
                    else:
                        j = int(self.rng.integers(0, n))
                        if j < self.keep:
                            s[j] = rec
                    w = _work(args)
                    if w > self.largest.get(name, (-1, None))[0]:
                        self.largest[name] = (w, rec)
                    if self.keep_all:
                        self.all.append((name, rec))
            return out
        return call

    def checked_calls(self, name: str) -> list:
        """The calls of ``name`` the output check reads: the sample and
        the largest, each once."""
        out = list(self.sample[name])
        big = self.largest.get(name)
        if big is not None and all(big[1] is not r for r in out):
            out.append(big[1])
        return out


def to_host(x):
    """A tensor (or a tuple of them) as numpy; anything else as it is."""
    if isinstance(x, (tuple, list)):
        return type(x)(to_host(v) for v in x)
    if hasattr(x, "detach"):
        return x.detach().cpu().numpy()
    return x


# ------------------------------------------------------------ trace ---

def span_timing():
    """The program's ``Timing`` (utils/timing.py), which also keeps each
    stage's host interval (thread, label, start, end) for the breakdown
    of idle gaps."""
    from lra_tpu_torch.utils.timing import Timing

    class SpanTiming(Timing):
        def __init__(self):
            super().__init__()
            self.spans: list = []

        def tick(self, label: str) -> None:
            now = time.perf_counter()
            last = getattr(self._tls, "last", now)
            super().tick(label)
            with self._lock:
                self.spans.append((threading.get_ident(), label, last, now))

    return SpanTiming()


def _kineto_events(prof):
    """(name, start, duration) of every device activity of a
    torch.profiler run, times in ns on the profiler's own clock, and that
    clock's value at the trace's start."""
    res = prof.profiler.kineto_results
    start = res.trace_start_ns() if hasattr(res, "trace_start_ns") else \
        res.trace_start_us() * 1000
    out = []
    for e in res.events():
        dt = e.device_type()
        if "CUDA" not in str(dt):
            continue
        if hasattr(e, "start_ns"):
            s, d = e.start_ns(), e.duration_ns()
        else:
            s, d = e.start_us() * 1000, e.duration_us() * 1000
        out.append((e.name(), s, d))
    return out, start


def device_intervals(prof, t_enter: float, wall_enter_ns: int,
                     mono_enter_ns: int) -> list:
    """Device activities as (name, start, end) in perf_counter seconds.
    The profiler's clock is matched to the host's by its value at the
    trace's start (wall clock or monotonic, whichever it is nearest),
    which lies at ``t_enter`` on the perf_counter to about a
    millisecond."""
    events, start = _kineto_events(prof)
    if not events:
        return []
    first = min(s for _n, s, _d in events)
    if abs(first - mono_enter_ns) < abs(first - wall_enter_ns):
        base_ns, base_s = mono_enter_ns, t_enter
    else:
        base_ns, base_s = wall_enter_ns, t_enter
    log(f"profiler clock: trace start {start}, first event {first}, "
        f"{'monotonic' if base_ns == mono_enter_ns else 'wall'} base")
    return sorted((n, base_s + (s - base_ns) / 1e9,
                   base_s + (s + d - base_ns) / 1e9) for n, s, d in events)


def union(intervals: list) -> list:
    """Merged [start, end] of (start, end) intervals."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def short_name(name: str) -> str:
    """A device operation's name without "void", namespaces and its
    argument list."""
    name = re.sub(r"^void\s+", "", name.replace("(anonymous namespace)::",
                                                ""))
    if name.endswith(")"):
        depth = 0
        for i in range(len(name) - 1, -1, -1):
            depth += {")": 1, "(": -1}.get(name[i], 0)
            if depth == 0:
                name = name[:i]
                break
    return name.strip()[:80]


class Records:
    """What a traced run hands the per-layer metric readers."""

    def __init__(self, **kw):
        self.__dict__.update(kw)

    @property
    def mb(self) -> float:
        return self.bases / 1e6


def device_name_matches(name: str, patterns) -> bool:
    return any(re.search(rf"\b{re.escape(p)}\b", name) for p in patterns)


def hand_kernels(ops: list, window: tuple, kernels: dict) -> dict:
    """{kernel: device seconds inside the window} from the device
    activities whose names match a roofline file's DEVICE."""
    t0, t1 = window
    out = {k: 0.0 for k in kernels}
    for name, s, e in ops:
        s, e = max(s, t0), min(e, t1)
        if e <= s:
            continue
        for k, mod in kernels.items():
            if device_name_matches(name, mod.DEVICE):
                out[k] += e - s
                break
    return out


def breakdown(ops: list, window: tuple, spans: list) -> dict:
    """The ten device operations that took most time in the window, and
    the ten longest idle gaps, each named by the host stages open across
    it (the stage of each worker thread that overlaps the gap most)."""
    t0, t1 = window
    per: dict = {}
    inside = []
    for name, s, e in ops:
        s, e = max(s, t0), min(e, t1)
        if e > s:
            per[short_name(name)] = per.get(short_name(name), 0.0) + e - s
            inside.append((s, e))
    busy = union(inside)
    gaps, prev = [], t0
    for s, e in busy:
        if s > prev:
            gaps.append((prev, s))
        prev = max(prev, e)
    if t1 > prev:
        gaps.append((prev, t1))
    gaps.sort(key=lambda g: g[0] - g[1])
    named = []
    for g0, g1 in gaps[:10]:
        cover: dict = {}
        for _th, label, s, e in spans:
            o = min(e, g1) - max(s, g0)
            if o > 0:
                cover[label] = cover.get(label, 0.0) + o
        top = sorted(cover.items(), key=lambda kv: -kv[1])[:3]
        what = " + ".join(k for k, _v in top) or "no stage open"
        named.append([f"{what} @{g0 - t0:.3f}s", g1 - g0])
    dev = sorted(per.items(), key=lambda kv: -kv[1])[:10]
    return {"device_ops": [[k, v] for k, v in dev], "idle_gaps": named}


def power_limit() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20).stdout.strip()
    except Exception as e:           # the reading is a label, not a result
        return f"not read ({type(e).__name__})"


if __name__ == "__main__":
    _save_index(json.loads(sys.argv[1]), sys.argv[2])
