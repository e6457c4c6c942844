"""The port's correlator profiler (gnsslib_tpu_torch.tools.profile_fast)
runs on the CPU at a narrow width, and refuses to stand in for the card."""
import torch

from gnsslib_tpu_torch.tools import profile_fast

torch.set_num_threads(2)


def test_profile_fast_cpu_narrow(capsys):
    """Every backend (eager, and replayed as a block program and as a
    one-super-step program) and every probe timed over 2 super-steps of 2
    channels; the kernel backends went through their plain versions once
    per step."""
    tags = profile_fast.BACKENDS + profile_fast.REPLAYED + profile_fast.PROBES
    assert profile_fast.main(["--device", "cpu", "--steps", "2",
                              "--channels", "2"]) == 0
    out = capsys.readouterr().out
    for tag in tags:
        assert f"\n{tag} " in out, tag
    res = profile_fast.profile("cpu", steps=2, channels=2, log=lambda m: 0)
    assert set(res) == set(tags)
    for corr in profile_fast.BACKEND_COUNTS:
        for tag in (corr, f"{corr}:graph", f"{corr}:step"):
            assert res[tag]["launches"] == 0 and res[tag]["plain"] == 1
    assert all(r["wall_ms"] > 0 and r["event_ms"] is None
               for r in res.values())


def test_profile_fast_duel_cpu(capsys):
    assert profile_fast.main(["--device", "cpu", "--steps", "1",
                              "--channels", "2", "--duel", "2"]) == 0
    out = capsys.readouterr().out
    assert "interleaved rounds" in out
    for tag in profile_fast.BACKENDS + profile_fast.REPLAYED:
        assert f"  {tag} " in out


def test_profile_fast_needs_the_card_unless_cpu(capsys):
    """Without a card the default ``--device cuda`` exits nonzero instead
    of timing the CPU under the card's name."""
    if torch.cuda.is_available():                     # pragma: no cover
        return
    assert profile_fast.main(["--steps", "1"]) == 2
    assert "no CUDA card" in capsys.readouterr().err
