"""Debug-by-dotplot dump system.

The reference's de-facto test harness (SURVEY.md §4): with ``-d --read
<name>`` every stage dumps TSV dot files for that read so each stage can
be eyeballed/diffed as a dotplot.  Stage names mirror the reference's
file names (all-matches.dots, roughClusters.dots, fineclusters_byunique,
Chains.tab, SparseDP.tab, alignment.dots, ...).

Enable with ``DotDumper(dir, read_name)``; the pipelines call ``dump``
at each stage when a dumper is installed for the read.
"""

from __future__ import annotations

import os

import numpy as np


class DotDumper:
    def __init__(self, out_dir: str, read_name: str):
        self.dir = out_dir
        self.read_name = read_name
        os.makedirs(out_dir, exist_ok=True)

    def dump(self, stage: str, qpos, tpos, lengths=None, extra=None) -> None:
        """Write one TSV: qStart tStart qEnd tEnd [extra...] per row."""
        path = os.path.join(self.dir, f"{stage}.dots")
        qpos = np.asarray(qpos)
        tpos = np.asarray(tpos)
        if lengths is None:
            lengths = np.zeros(len(qpos), np.int64)
        lengths = np.asarray(lengths)
        with open(path, "a") as f:
            for i in range(len(qpos)):
                row = [qpos[i], tpos[i], qpos[i] + lengths[i],
                       tpos[i] + lengths[i]]
                if extra is not None:
                    row.extend(np.atleast_1d(extra[i]).tolist()
                               if not np.isscalar(extra[i]) else [extra[i]])
                f.write("\t".join(str(x) for x in row) + "\n")

    def dump_clusters(self, stage: str, clusters) -> None:
        path = os.path.join(self.dir, f"{stage}.tab")
        with open(path, "a") as f:
            for m, c in enumerate(clusters):
                ln = c.anchor_lengths()
                for i in range(len(c)):
                    f.write(f"{c.qpos[i]}\t{c.tpos[i]}\t"
                            f"{c.qpos[i] + ln[i]}\t{c.tpos[i] + ln[i]}\t"
                            f"{m}\t{c.strand}\n")

    def dump_blocks(self, stage: str, segments) -> None:
        path = os.path.join(self.dir, f"{stage}.dots")
        with open(path, "a") as f:
            for s, seg in enumerate(segments):
                for (q, t, ln) in seg.blocks:
                    f.write(f"{q}\t{t}\t{q + ln}\t{t + ln}\t{s}\t"
                            f"{seg.strand}\n")
