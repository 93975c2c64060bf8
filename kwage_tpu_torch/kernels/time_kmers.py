"""Time versions of ``csrc/kmers.cu`` beside each other on one card.

    python -m kwage_tpu_torch.kernels.time_kmers [other_kmers.cu ...]

The same as ``python -m kwage_tpu_torch.kernels.time_kernel kmers ...``:
see that module for what is compiled, compared and timed.
"""

from __future__ import annotations

import sys

from . import time_kernel


def main(argv: list[str]) -> int:
    return time_kernel.main(["kmers", *argv])


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
