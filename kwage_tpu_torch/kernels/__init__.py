"""Hand-written CUDA kernels for Hopper: build, bind, launch, count.

The sources are ``kwage_tpu_torch/csrc/*.cu`` (and ``*.cuh``). On first use
each ``.cu`` compiles with ``nvcc`` for ``sm_90a`` (all at once, one
process each) and the objects link into ONE shared library with a plain C
interface, named by a sha256 of the sources and written under
``build/kwage_tpu_torch/`` at the repository root (git-ignored), then load
with ``ctypes``. Nothing is built when this module is imported, and nothing
here falls back: a failed build or launch raises.

Every C entry point launches on the stream it is given, allocates nothing,
and returns ``cudaGetLastError()``; ``launch`` raises when that is not 0
and otherwise adds one to the kernel's launch count. The counts let a run
show that its main path went through the kernels (``launch_counts``).
Three exported functions launch nothing: ``kw_search_scratch_words``,
``kw_run_scratch_words`` and ``kw_merge_scratch_words``, the sizes of the
scratch ``search_total_hits``, ``run_counts`` and ``merge_counts`` take
(``scratch_words``).
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build", "kwage_tpu_torch")

NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

# C entry point (without the "kw_" prefix) -> argument types. Pointers and
# the stream are c_void_p (a plain int would be cut to 32 bits).
_VP, _I64 = ctypes.c_void_p, ctypes.c_int64
_ENTRIES = {
    # (x, out, F, W, stream)
    "bit_transpose": [_VP, _VP, _I64, _I64, _VP],
    # (db, idx, valid, out, nq, nk, nh, W, stream)
    "search_complete": [_VP, _VP, _VP, _VP, _I64, _I64, _I64, _I64, _VP],
    "search_counts": [_VP, _VP, _VP, _VP, _I64, _I64, _I64, _I64, _VP],
    # (db, idx, valid, tcount, out, scratch, nq, nk, nh, W, stream); scratch:
    # scratch_words("search", nq, W) int32 words
    "search_total_hits": [_VP, _VP, _VP, _VP, _VP, _VP, _I64, _I64, _I64, _I64, _VP],
    # (packed, valid_words, words, valid, R, w16, w32, length, k, stream)
    "canonical_kmers": [_VP, _VP, _VP, _VP, _I64, _I64, _I64, _I64, _I64, _VP],
    # (ascii, words, valid, R, stride, length, k, stream)
    "canonical_kmers_ascii": [_VP, _VP, _VP, _I64, _I64, _I64, _I64, _VP],
    # (words, out, n, k, nh, mask, stream)
    "murmur32": [_VP, _VP, _I64, _I64, _I64, _I64, _VP],
    # (acc, words, hist, kept, n, limit, word_bits, acc_bits, widths,
    #  passes, stream): every pass's digit counts in one read
    "radix_sort_hist": [_VP, _VP, _VP, _VP, _I64, _I64, _I64, _I64, _I64, _I64, _VP],
    # (acc, words, acc_a, acc_b, words_a, words_b, acc_out, hist, lookback,
    #  counters, n, n_kept, limit, word_bits, acc_bits, widths, passes,
    #  lookback_entries, stream): one call runs every pass
    "radix_sort_pairs": [_VP] * 10 + [_I64] * 8 + [_VP],
    # (acc_s, words_s, selected, num_valid, n, num_acc, min_count, stream)
    "select_runs": [_VP, _VP, _VP, _VP, _I64, _I64, _I64, _VP],
    # (acc_s, words_s, selected, slot_of_acc, out, n, num_acc, k, nh,
    #  log2_len, words_per_filter, stream)
    "bloom_set_bits": [_VP, _VP, _VP, _VP, _VP, _I64, _I64, _I64, _I64, _I64,
                       _I64, _VP],
    # (words, valid, lengths, table, out, scratch, B, nwin, k, size, ns,
    #  out_stride, stream)
    "sriracha_counts_lut": [_VP, _VP, _VP, _VP, _VP, _VP, _I64, _I64, _I64, _I64,
                            _I64, _I64, _VP],
    # (words, valid, lengths, keys, masks, row0, bmask, out, scratch, B, nwin,
    #  k, ns, out_stride, stream)
    "sriracha_counts_hash": [_VP, _VP, _VP, _VP, _VP, _VP, _VP, _VP, _VP, _I64,
                             _I64, _I64, _I64, _I64, _VP],
    # (subjects, out, ns, smax, size, stream)
    "subject_table": [_VP, _VP, _I64, _I64, _I64, _VP],
    # (words, weights, words_out, counts_out, selected, stats, scratch, n, cap,
    #  min_count, stream)
    "run_counts": [_VP] * 7 + [_I64] * 3 + [_VP],
    # (words_a, counts_a, words_b, counts_b, words_out, counts_out, selected,
    #  stats, scratch, na, nb, cap, min_count, stream)
    "merge_counts": [_VP] * 9 + [_I64] * 4 + [_VP],
}

# Entry points that launch another entry's kernel on another input layout,
# or a step of it; their launches count under that kernel's name.
# The scratch-size functions: name -> argument types.
_SCRATCH = {"search": [_I64, _I64], "run": [_I64], "merge": [_I64, _I64]}

_KERNEL_OF = {"canonical_kmers_ascii": "canonical_kmers", "radix_sort_hist": "radix_sort_pairs"}

_LOCK = threading.Lock()
_LIB: ctypes.CDLL | None = None
_LAUNCHES = {name: 0 for name in _ENTRIES if name not in _KERNEL_OF}


def sources() -> list[str]:
    return sorted(glob.glob(os.path.join(CSRC_DIR, "*.cu"))
                  + glob.glob(os.path.join(CSRC_DIR, "*.cuh")))


def source_tag() -> str:
    """sha256 over the kernel sources' names and bytes (16 hex digits)."""
    h = hashlib.sha256()
    for path in sources():
        h.update(os.path.basename(path).encode())
        with open(path, "rb") as f:
            h.update(f.read())
    return h.hexdigest()[:16]


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME:
        cand = os.path.join(CUDA_HOME, "bin", "nvcc")
        if os.path.exists(cand):
            return cand
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return found


def build() -> str:
    """Compile the kernel library if no build of these sources exists;
    return its path. Every ``.cu`` compiles in its own ``nvcc`` process,
    all started together, then one ``nvcc -shared`` links them. The
    compiler's report (``-Xptxas -v``: registers, shared memory, spills
    per kernel) is kept beside the library as ``.log``."""
    so_path = os.path.join(BUILD_DIR, f"libkwage_kernels_{source_tag()}.so")
    if os.path.exists(so_path):
        return so_path
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{so_path}.{os.getpid()}"
    nvcc = _nvcc()
    cus = [s for s in sources() if s.endswith(".cu")]
    objs = [f"{tmp}.{os.path.basename(s)}.o" for s in cus]
    cmds = [[nvcc, *NVCC_FLAGS, "-c", "-o", o, s] for s, o in zip(cus, objs)]
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True) for c in cmds]
    results = [(c, p.communicate()[0], p.returncode) for c, p in zip(cmds, procs)]
    if all(rc == 0 for _, _, rc in results):
        cmd = [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-shared",
               "-o", f"{tmp}.so", *objs]
        res = subprocess.run(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                             text=True)
        results.append((cmd, res.stdout, res.returncode))
    report = "".join(" ".join(c) + "\n" + out for c, out, _ in results)
    with open(so_path[:-3] + ".log", "w") as f:
        f.write(report)
    for o in objs:
        if os.path.exists(o):
            os.remove(o)
    failed = [rc for _, _, rc in results if rc != 0]
    if failed:
        raise RuntimeError(f"nvcc failed ({failed[0]}):\n{report}")
    os.replace(f"{tmp}.so", so_path)
    return so_path


def get_lib() -> ctypes.CDLL:
    """The bound kernel library, built on first use."""
    global _LIB
    with _LOCK:
        if _LIB is None:
            lib = ctypes.CDLL(build())
            for name, argtypes in _ENTRIES.items():
                fn = getattr(lib, "kw_" + name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            lib.kw_error_string.argtypes = [ctypes.c_int]
            lib.kw_error_string.restype = ctypes.c_char_p
            for name, argtypes in _SCRATCH.items():
                fn = getattr(lib, f"kw_{name}_scratch_words")
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int64
            _LIB = lib
        return _LIB


def launch(name: str, *args) -> None:
    """Launch a kernel through the C entry point ``name``; raise on a CUDA
    error, else count the launch under the kernel's name."""
    lib = get_lib()
    err = getattr(lib, "kw_" + name)(*args)
    if err:
        raise RuntimeError(
            f"{name} launch failed: CUDA error {err} "
            f"({lib.kw_error_string(err).decode()})")
    with _LOCK:
        _LAUNCHES[_KERNEL_OF.get(name, name)] += 1


def scratch_words(name: str, *sizes: int) -> int:
    """Words of scratch an entry takes: ``search`` (nq, W): int32 words for
    search_total_hits (its counts, int32 [nq, W*32]); ``run`` (n): uint64
    words for run_counts; ``merge`` (na, nb): uint64 words for
    merge_counts."""
    return getattr(get_lib(), f"kw_{name}_scratch_words")(*sizes)



def launch_counts() -> dict[str, int]:
    with _LOCK:
        return dict(_LAUNCHES)


def reset_launch_counts() -> None:
    with _LOCK:
        for name in _LAUNCHES:
            _LAUNCHES[name] = 0
