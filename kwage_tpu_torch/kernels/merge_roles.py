"""Where a tile's time goes in csrc/merge.cu: each role's clock per tile.

    python -m kwage_tpu_torch.kernels.merge_roles

Nsight Compute does not run on the machine with the card, so this tool
patches a copy of ``csrc/merge.cu`` instead: at the borders between the
steps of a tile, one thread of each role (consumer thread 0, thread 0 of
each storer group, the producer lane) adds the ``clock64()`` cycles since
the last border to a counter past the kernel's scratch. The copy compiles
alone (``time_kernel.load``) into ``build/kwage_tpu_torch/``; the library
the package uses is not touched. It runs ``run_counts`` over a 46 Mbp
accession's 36,799,920 sorted windows (6.7 M distinct, cap = min_count =
5) and ``merge_counts`` of the last of its 6 chunk merges, three times
each, and prints each step's microseconds a tile (cycles at the 1.98 GHz
SM clock; both storer groups' sums over all tiles, so a group spends twice
its figure on each tile it takes); then the partition and merge kernels'
device times from ``torch.profiler``. The counters' atomics and the
clock reads cost time of their own: compare steps, not totals, with the
kernel's time from ``time_kernel merge``.
"""

from __future__ import annotations

import os
import subprocess

import torch

from . import BUILD_DIR, CSRC_DIR
from .time_kernel import load

SM_HZ = 1.98e9
# Counter index -> the step it times, from the border before it.
STEPS = ["consumer: wait for the tile", "consumer: count or merge", "consumer: block scan",
         "consumer: stage, hand over", "storer: wait for a tile", "storer: look back",
         "storer: store", "producer: wait for a free stage", "", "tiles (and stops)",
         "consumer: staging", "consumer: merge path"]
TILES = 9


def _add(k: int, who: str) -> str:
    return (f"if ({who}) atomicAdd(prof + {k}, (unsigned long long)(clock64() - _c0)); "
            "_c0 = clock64();")


def patched_source() -> str:
    """csrc/merge.cu with the counters at each step's border."""
    with open(os.path.join(CSRC_DIR, "merge.cu")) as f:
        src = f.read()

    def patch(old: str, new: str, count: int) -> None:
        nonlocal src
        if src.count(old) != count:
            raise RuntimeError(f"merge.cu changed: {old!r} appears {src.count(old)} times")
        src = src.replace(old, new)

    full = "    mbar_wait(&sh.full[s], (it / kInStages) & 1);\n"
    patch(full, "    long long _c0 = clock64();\n" + full + "    " + _add(0, "ct == 0")
          + f" if (ct == 0) atomicAdd(prof + {TILES}, 1ull);\n", 2)
    patch("    uint32_t total;\n    uint32_t run = ",
          "    " + _add(1, "ct == 0") + "\n    uint32_t total;\n    uint32_t run = ", 2)
    patch("    publish_count(tile, total, scratch, ct);\n",
          "    publish_count(tile, total, scratch, ct);\n    " + _add(2, "ct == 0") + "\n", 2)
    patch("      run += __popc(ballots[i]);\n    }\n",
          "      run += __popc(ballots[i]);\n    }\n    " + _add(10, "ct == 0") + "\n", 1)
    patch("    tile_done(sh, it, s, tile, total, ct);\n",
          "    tile_done(sh, it, s, tile, total, ct);\n    " + _add(3, "ct == 0") + "\n", 2)
    patch("    bool have_prev = dt > 0;\n",
          "    " + _add(11, "ct == 0") + "\n    bool have_prev = dt > 0;\n", 1)
    patch("    mbar_wait(&sh.staged[g], use & 1);\n",
          "    long long _c0 = clock64();\n    mbar_wait(&sh.staged[g], use & 1);\n    "
          + _add(4, "st == 0") + "\n", 1)
    patch("    group_sync(g);\n", "    group_sync(g);\n    " + _add(5, "st == 0") + "\n", 1)
    patch("    if (lane == 0) mbar_arrive(&sh.free[g]);\n  }\n",
          "    if (lane == 0) mbar_arrive(&sh.free[g]);\n    " + _add(6, "st == 0") + "\n  }\n", 1)
    empty = "      mbar_wait(&sh.empty[s], ((it / kInStages) & 1) ^ 1);\n"
    patch(empty, "      long long _c0 = clock64();\n" + empty + "      " + _add(7, "true") + "\n", 2)
    # The counters: past the scratch's look-back words and its three.
    patch("  unsigned long long* tail = scratch + num_tiles;\n",
          "  unsigned long long* tail = scratch + num_tiles;\n"
          "  unsigned long long* prof = tail + kScratchTail;\n", 2)
    storer = "  const int st = (threadIdx.x - kConsumers) % kGroupThreads, lane = st & 31;\n"
    patch(storer, storer + "  unsigned long long* prof = lookback + num_tiles + kScratchTail;\n", 1)
    return src


def report(label: str, counters: torch.Tensor) -> None:
    v = counters.tolist()
    tiles = v[TILES]
    print(f"{label}, {tiles} tiles and stops: " + "; ".join(
        f"{name} {v[i] / tiles / SM_HZ * 1e6:.3f} us" for i, name in enumerate(STEPS)
        if name and i != TILES and v[i]), flush=True)


def main() -> int:
    from ..ops.counting import run_counts_ref

    os.makedirs(BUILD_DIR, exist_ok=True)
    path = os.path.join(BUILD_DIR, "merge_roles.cu")
    with open(path, "w") as f:
        f.write(patched_source())
    lib = load(path, ("run_counts", "merge_counts"))
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    st = torch.cuda.current_stream().cuda_stream
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())

    def outputs(m):
        return [torch.empty(m, dtype=torch.int64, device=dev),
                torch.empty(m, dtype=torch.int32, device=dev),
                torch.empty(m, dtype=torch.uint8, device=dev),
                torch.empty(2, dtype=torch.int64, device=dev)]

    n, distinct, cap = 36_799_920, 6_732_793, 5
    pool = torch.randint(0, 1 << 62, (distinct,), device=dev, generator=gen)
    words = torch.sort(pool[torch.randint(0, distinct, (n,), device=dev, generator=gen)]).values
    outs, tiles = outputs(n), -(-n // 4096)
    for _ in range(3):
        scratch = torch.zeros(tiles + 3 + 16, dtype=torch.int64, device=dev)
        if lib.kw_run_counts(words.data_ptr(), 0, *(t.data_ptr() for t in outs),
                             scratch.data_ptr(), n, cap, cap, st):
            raise RuntimeError("run_counts launch failed")
        torch.cuda.synchronize()
        report("run_counts, a 46 Mbp accession", scratch[tiles + 3:])
    del words, outs

    def run_of(m):
        w, c, stats, _ = run_counts_ref(torch.sort(pool[torch.randint(
            0, distinct, (m,), device=dev, generator=gen)]).values, None, cap)
        return w[: int(stats[0])].clone(), c[: int(stats[0])].clone()

    wa, ca = run_of(n - n // 6)
    wb, cb = run_of(n // 6)
    na, nb = wa.shape[0], wb.shape[0]
    outs, tiles = outputs(na + nb), -(-(na + nb) // 4096)
    scratch = torch.zeros(3 * tiles + 5 + 16, dtype=torch.int64, device=dev)

    def merge():
        if lib.kw_merge_counts(wa.data_ptr(), ca.data_ptr(), wb.data_ptr(), cb.data_ptr(),
                               *(t.data_ptr() for t in outs), scratch.data_ptr(), na, nb, cap,
                               cap, st):
            raise RuntimeError("merge_counts launch failed")

    for _ in range(3):
        scratch.zero_()
        merge()
        torch.cuda.synchronize()
        report("merge_counts, the last of a 46 Mbp accession's 6 merges",
               scratch[3 * tiles + 5:])
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(5):
            merge()
        torch.cuda.synchronize()
    for e in prof.key_averages():
        if e.device_time_total > 0:
            print(f"merge_counts' {e.key.split('(')[0].split('::')[-1]}: "
                  f"{e.device_time_total / e.count / 1e3:.4f} ms a call ({e.count} calls)",
                  flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
