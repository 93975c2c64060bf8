"""kwage_tpu_torch.ops.transpose (the port's bit transpose) against the JAX
package's packed_bit_transpose and the host transpose. Integer data:
every comparison is exact."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from kwage_tpu.ops import transpose as jax_transpose
from kwage_tpu.pipeline.build_db import transpose_filters
from kwage_tpu_torch.ops import transpose as tt
from kwage_tpu_torch.ops.search import tensor_to_words, words_to_tensor

CPU = torch.device("cpu")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; chip_smoke.py checks the kernel on the card")
    return torch.device("cuda")


def _words(F, B, seed):
    rng = np.random.default_rng(seed)
    filters = rng.integers(0, 256, size=(F, B), dtype=np.uint8)
    return filters, tt.pack_filters_to_words(filters)


# Filter count x filter bytes: the JAX package's own shapes plus one past
# its 4096-filter Pallas tile and a word count that is not a multiple of 128.
SHAPES = [(32, 4), (64, 16), (256, 128), (96, 20), (4096 + 32, 16), (64, 4 * 130)]


@pytest.mark.parametrize("F,B", SHAPES)
def test_transpose_ref_matches_jax(F, B):
    _, words = _words(F, B, seed=F + B)
    want = np.asarray(jax_transpose.packed_bit_transpose(jnp.asarray(words)))
    got = tensor_to_words(tt.packed_bit_transpose_ref(words_to_tensor(words, CPU)))
    np.testing.assert_array_equal(got, want)


def test_pack_filters_to_words_matches_jax():
    filters, words = _words(7, 10, seed=1)  # 10 bytes: pads to 3 words
    np.testing.assert_array_equal(words, jax_transpose.pack_filters_to_words(filters))


def test_wrapper_pads_filters_to_32():
    """The wrapper takes any F (zero rows pad it to a multiple of 32) and on
    a CPU tensor runs the plain version."""
    filters, words = _words(37, 12, seed=2)
    got = tensor_to_words(tt.packed_bit_transpose(words_to_tensor(words, CPU)))
    assert got.shape == (3 * 32, 2)
    padded = np.pad(words, ((0, 64 - 37), (0, 0)))
    want = np.asarray(jax_transpose.packed_bit_transpose(jnp.asarray(padded)))
    np.testing.assert_array_equal(got, want)


def test_wrapper_rejects_non_int32():
    with pytest.raises(ValueError):
        tt.packed_bit_transpose(torch.zeros((32, 2), dtype=torch.int64))


@pytest.mark.parametrize("chunk_bits", [1024, 4096])
def test_transpose_chunks_device_matches_jax_and_host(chunk_bits):
    rng = np.random.default_rng(chunk_bits)
    F, L = 37, 4096  # a filter count that is not a multiple of 8
    filters = rng.integers(0, 256, size=(F, L // 8), dtype=np.uint8)
    want = transpose_filters(filters)
    got = tt.transpose_chunks_device(filters, CPU, chunk_bits=chunk_bits)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        got, jax_transpose.transpose_chunks_device(filters, chunk_bits=chunk_bits))


@pytest.mark.cuda
def test_bit_transpose_kernel_matches_ref(cuda_device):
    for F, B in SHAPES + [(2048, 1 << 15)]:
        _, words = _words(F, B, seed=F)
        x = words_to_tensor(words, cuda_device)
        got = tt.packed_bit_transpose(x)
        want = tt.packed_bit_transpose_ref(x)
        torch.cuda.synchronize()
        assert torch.equal(got, want), (F, B)


def _blooms(tmp_path, n=5, log2_len=14, seed=9):
    import zlib

    from kwage_tpu.core import FilterInfo, str_to_accession
    from kwage_tpu.core.params import BloomParam
    from kwage_tpu.io.bloom_file import BloomFilterRecord, write_bloom_file

    rng = np.random.default_rng(seed)
    param = BloomParam(kmer_len=31, log_2_filter_len=log2_len, num_hash=3, hash_func=0)
    paths = []
    for i in range(n):
        bits = rng.integers(0, 256, size=param.filter_len // 8, dtype=np.uint8)
        rec = BloomFilterRecord(
            param=param, crc32=zlib.crc32(bits.tobytes()) & 0xFFFFFFFF,
            info=FilterInfo(run_accession=str_to_accession(f"SRR{i + 1}")), bits=bits)
        paths.append(str(tmp_path / f"f{i}.bloom"))
        write_bloom_file(paths[-1], rec)
    return param, paths


def _port_param(param):
    """The port's own BloomParam with the fields of kwage_tpu's."""
    import dataclasses

    from kwage_tpu_torch.core.params import BloomParam

    return BloomParam(**dataclasses.asdict(param))


@pytest.mark.parametrize("device", [True, CPU, False])
def test_build_db_bytes_identical_to_jax_host(tmp_path, monkeypatch, device):
    """The port's pack (device=True through KWAGE_TORCH_DEVICE, an explicit
    torch.device, or the host branch) writes the JAX package's host bytes
    and its device bytes, over several chunks."""
    from kwage_tpu.pipeline.build_db import build_db_from_bloom_files as jax_build
    from kwage_tpu_torch.pipeline.build_db import build_db_from_bloom_files

    monkeypatch.setenv("KWAGE_TORCH_DEVICE", "cpu")
    param, blooms = _blooms(tmp_path)
    host, jax_dev, port = (tmp_path / n for n in ("host.db", "jax.db", "port.db"))
    jax_build(str(host), param, blooms, chunk_bits=1 << 12)
    jax_build(str(jax_dev), param, blooms, chunk_bits=1 << 12, device=True)
    build_db_from_bloom_files(str(port), _port_param(param), blooms, chunk_bits=1 << 12,
                              device=device)
    assert port.read_bytes() == host.read_bytes() == jax_dev.read_bytes()


@pytest.mark.parametrize("fault,message", [
    ("crc", "invalid Bloom filter crc32"), ("params", "inconsistent Bloom parameters"),
    ("incomplete", "not complete"), ("truncated", "truncated filter data")])
def test_build_db_rejects_bad_blooms(tmp_path, fault, message):
    from kwage_tpu_torch.core.params import BloomParam
    from kwage_tpu_torch.pipeline.build_db import build_db_from_bloom_files

    param, blooms = _blooms(tmp_path, n=3)
    param = _port_param(param)
    path = blooms[1]
    data = bytearray(open(path, "rb").read())
    if fault == "crc":
        data[-1] ^= 0x10                 # one filter bit: crc32 mismatch
    elif fault == "incomplete":
        data[0] = 0x00                   # in-progress magic
    elif fault == "truncated":
        data = data[:-100]
    open(path, "wb").write(bytes(data))
    if fault == "params":
        param = BloomParam(kmer_len=31, log_2_filter_len=14, num_hash=4, hash_func=0)
    with pytest.raises(ValueError, match=message):
        build_db_from_bloom_files(str(tmp_path / "out.db"), param, blooms, device=CPU)
