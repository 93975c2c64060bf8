"""chip_smoke.py's own parts that run on the CPU: the phase walls it prints,
the cut depths of its earlier programs, and phase 8's long-read runs at a
small size (the plain versions, held to the host engine's bytes)."""

import torch

import chip_smoke
from kwage_tpu_torch.sriracha import device as tdev


def test_phase_walls_print_each_phase_and_sum_them(capsys, monkeypatch):
    clock = iter([0.0, 1.5, 10.0, 12.25, 20.0, 20.5])
    monkeypatch.setattr(chip_smoke.time, "perf_counter", lambda: next(clock))
    walls = chip_smoke.PhaseWalls()
    with walls("build"):
        pass
    with walls("8 sriracha"):
        pass
    with walls("build"):   # a phase timed twice adds up
        pass
    out = capsys.readouterr().out.splitlines()
    assert out == ["phase build: 1.5 s", "phase 8 sriracha: 2.2 s", "phase build: 0.5 s"]
    assert walls.walls == {"build": 2.0, "8 sriracha": 2.25}
    assert walls.summary() == 'phase walls (s): {"build": 2.0, "8 sriracha": 2.2}; 4.2 s in all'


def test_earlier_programs_run_cut_in_depth():
    """The smoke's time: bench.serve at 1000 of its 4350 accessions and the
    distributed proof at 250 of its 1000, through the knobs the programs
    already read; every other program at its defaults."""
    serve = [extra for name, _, extra, _ in chip_smoke.BENCH_RUNS if name == "serve"]
    assert serve == [{"SCALE_N_ACC": "1000"}]
    tools = dict((module, extra) for module, extra, _ in chip_smoke.TOOL_RUNS)
    assert tools.pop("scale.distributed") == {"SCALE_SKIP_LATENCY": "1", "SCALE_N_ACC": "250"}
    assert all(extra == {} for extra in tools.values())


def test_long_read_runs_on_the_cpu(tmp_path, monkeypatch):
    """Phase 8's long-read runs on the CPU at 600 reads and 8 subjects:
    both probes' TSVs equal the host engine's bytes and list every subject
    (``run_sriracha_long``'s own checks); every read lies in a bucket of
    the block kernel at both k, the buckets' edges among them."""
    monkeypatch.setenv("KWAGE_TORCH_DEVICE", "cpu")
    monkeypatch.setattr(chip_smoke, "LR_READS", 600)
    monkeypatch.setattr(chip_smoke, "SR_SUBJECTS", 8)
    monkeypatch.setattr(chip_smoke, "HOST_THREADS", 2)   # the suite shares its cores
    done = chip_smoke.run_sriracha_long(str(tmp_path), torch.device("cpu"), 0)
    assert sorted(done) == ["C", "D"] and [done[t][0] for t in "CD"] == [21, 11]
    with open(done["C"][3]) as f:
        lengths = [len(line.strip()) for i, line in enumerate(f) if i % 4 == 1]
    assert len(lengths) == 600 and sum(lengths) == done["C"][4]
    assert set(chip_smoke.LR_EDGES) <= set(lengths)
    for k in (11, 21):
        assert {tdev.fused_kernel(tdev.pad_len(n), k) for n in lengths} == {"sriracha_block"}
