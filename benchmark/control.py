"""The control of each cell's check: whole runs with the reference put in
the program's place at a lower precision of its guarantee.

    python3 -m benchmark.control --workload <cell> --seeds 11,12,13 [--seconds 10]

For each seed, one run of the cell through ``run.run_cell`` (its set-up,
window, clients and check, at the cell's own sizes), in which
``ResidentSearcher.search`` answers from the plain reference
(``reference.search``) over the .db files the server loaded, keeping every
second distinct k-mer of each query: an approximate search where the
configuration states exact hit lists. The server still parses, renders and
replies. The run's own check must come out not correct. It prints one JSON
line a seed: ``correct`` and each number compared beside its limit. The
runs of the benchmark do not run this.
"""

from __future__ import annotations

import argparse
import json
import os
import threading

import torch

from . import corpus, manifest, run

KMER_STEP = 2


def reference_in_place(cfg: dict, device: torch.device, kmer_step: int = KMER_STEP):
    """Replace ``ResidentSearcher.search`` by the reference at ``kmer_step``
    over the searcher's own files; return a function that restores it."""
    from kwage_tpu_torch.search.engine import MatchResult
    from kwage_tpu_torch.search.resident import ResidentSearcher

    program = ResidentSearcher.search
    lock = threading.Lock()

    def search(self, queries, threshold):
        with lock:
            if "_control" not in self.__dict__:
                ref = corpus.reference(cfg, self.db_paths, device)
                self._control = (ref, {name: r for r, name in enumerate(ref.names)})
        ref, index = self._control
        answer = ref.answer([q for _, q in queries], threshold, kmer_step=kmer_step)
        out = {}
        for i, hits in answer.items():
            matches = []
            for name, found, n in hits:
                fi, f = divmod(index[name], cfg["filters_per_file"])
                info = self._info_cache.get((fi, f))
                if info is None:
                    info = self._info_cache[(fi, f)] = self._readers[fi].read_filter_info(f)
                matches.append(MatchResult(found, n, info))
            out[queries[i][0]] = matches
        return out

    ResidentSearcher.search = search

    def restore() -> None:
        ResidentSearcher.search = program

    return restore


def readings(doc: dict, name: str, seed: int, seconds: float, device: torch.device,
             root=None) -> dict:
    """One run of cell ``name`` with the control in the program's place."""
    cell = manifest.cell(doc, name)
    restore = reference_in_place(manifest.config(cell["config"], root), device)
    try:
        r = run.run_cell(doc, name, seed, seconds, False, device, root)
    finally:
        restore()
    return {"workload": name, "seed": seed, "correct": r["correct"],
            "attempted": r["attempted"], "checks": r["checks"]}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--seconds", type=float, default=10.0)
    args = ap.parse_args(argv)
    os.environ["KWAGE_TORCH_DEVICE"] = "cuda"
    doc = manifest.load()
    for seed in (int(s) for s in args.seeds.split(",")):
        print(json.dumps(readings(doc, args.workload, seed, args.seconds,
                                  torch.device("cuda", 0))), flush=True)


if __name__ == "__main__":
    main()
