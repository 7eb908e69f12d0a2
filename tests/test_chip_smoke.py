"""chip_smoke.py: the parts that run without a GPU.

The script itself runs only on GPUs; here its device check, option handling,
output contract and phase logic are exercised on the CPU."""

import json
import os
import subprocess
import sys

import jax
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402


class _FakeGPU:
    platform = "gpu"
    device_kind = "fake"


def test_exits_nonzero_without_gpu():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode != 0
    assert "no GPU found" in r.stderr
    assert '"ok"' not in r.stdout


@pytest.mark.parametrize("argv,phase", [([], "one_card"),
                                        (["--four-cards"], "four_cards")])
def test_options_select_phases(monkeypatch, capsys, argv, phase):
    calls = []
    monkeypatch.setattr(chip_smoke, "check_device", lambda: _FakeGPU())
    monkeypatch.setattr(chip_smoke, "one_card", lambda: calls.append(
        "one_card"))
    monkeypatch.setattr(chip_smoke, "four_cards", lambda: calls.append(
        "four_cards"))
    assert chip_smoke.main(argv) == 0
    assert calls == [phase]
    last = capsys.readouterr().out.strip().splitlines()[-1]
    assert json.loads(last) == {"ok": True, "device": {
        "platform": "gpu", "kind": "fake", "count": len(jax.devices())}}


def test_accuracy_phase_within_tolerance():
    chip_smoke.accuracy(cells=3)


def test_failed_iteration_contract_exits(monkeypatch):
    params = chip_smoke.load_config("e2e_aniso_q4.json")
    params["n refinements"] = 1
    params["solver"]["best of"] = 1
    monkeypatch.setattr(chip_smoke, "peak_bytes", lambda dev: 0)
    monkeypatch.setattr(chip_smoke, "live_bytes", lambda dev: 0)
    r = chip_smoke.solve("tiny", params, lambda its: its > 0)
    assert r["converged"]
    with pytest.raises(SystemExit, match="iteration contract"):
        chip_smoke.solve("tiny", params, lambda its: False)


@pytest.mark.parametrize("config", ["e2e_aniso_q4.json", "e2e_kershaw_q4.json",
                                    "e2e_ball_q4.json"])
def test_smoke_configs_select_tf32_fdm(config):
    """The three smoke solves were measured on the card with TF32 FDM
    applies; their configs name it."""
    params = chip_smoke.load_config(config)
    assert chip_smoke.fdm_precision(params) == "tensorfloat32"


def test_solve_line_says_whose_peak(monkeypatch, capsys):
    """A solve that does not raise the process's high-water mark reports
    it with peak_is_own false; each line says what was live before it."""
    params = chip_smoke.load_config("e2e_aniso_q4.json")
    params["n refinements"] = 1
    params["solver"]["best of"] = 1
    peaks = iter([5, 7, 7, 7])
    monkeypatch.setattr(chip_smoke, "peak_bytes", lambda dev: next(peaks))
    monkeypatch.setattr(chip_smoke, "live_bytes", lambda dev: 3)
    chip_smoke.solve("first", params, lambda its: its > 0)
    chip_smoke.solve("second", params, lambda its: its > 0)
    lines = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("{")]
    assert [(d["peak_bytes_in_use"], d["peak_is_own"], d["bytes_in_use_before"])
            for d in lines] == [(7, True, 3), (7, False, 3)]


def test_four_cards_phase_compares_with_one_card(monkeypatch, capsys):
    """--four-cards runs the flagship sharded over four devices and on one,
    with the same iteration count (here at a small size, on CPU devices)."""
    orig = chip_smoke.load_config

    def small(name):
        params = orig(name)
        params["n refinements"] = 3
        params["solver"]["best of"] = 1
        return params

    from dealii_asm.models.poisson import run_config

    its = run_config(small("e2e_aniso_q4.json"), log=lambda *_: None)["it"]
    monkeypatch.setattr(chip_smoke, "load_config", small)
    monkeypatch.setattr(chip_smoke, "peak_bytes", lambda dev: 1 << 40)
    monkeypatch.setattr(chip_smoke, "live_bytes", lambda dev: 0)
    monkeypatch.setattr(chip_smoke, "FLAGSHIP_ITS", its)
    chip_smoke.four_cards()
    lines = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("{")]
    assert [d["its"] for d in lines if "its" in d] == [its, its]
    peaks = [d for d in lines if "peak_bytes_in_use_per_card" in d]
    assert len(peaks[0]["peak_bytes_in_use_per_card"]) == 4
