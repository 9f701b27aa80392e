"""The port's one-card launchers, ``repro_torch.launch.train`` and
``repro_torch.launch.serve``, against the reference's on the CPU, at
``reduced_config`` sizes.

* ``launch.train`` refuses a frontend arch (the encoder's frames, the
  VLM's prefix) with the reference's message (naming the port's example
  drivers in place of the reference's), and trains the MoE, SSM and
  hybrid families a few steps with checkpoints;
* ``launch.serve`` submits the reference launcher's seeded requests (the
  same prompts and budgets, read off the reference's ``main`` with its
  engine stubbed out) for a dense, an MoE, an SSM and a hybrid config and
  serves each its budget of tokens; an encoder is refused with the
  reference's message;
* both need CUDA unless told ``--device cpu``.
"""
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _train_families import one_thread  # noqa: E402,F401
from repro.launch import serve as jserve  # noqa: E402
from repro.launch import train as jtrain  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.launch import train as ttrain  # noqa: E402

TRAIN_ARCHS = ["olmoe-1b-7b", "qwen2-moe-a2.7b", "xlstm-1.3b", "zamba2-2.7b"]
SERVE_ARCHS = ["llama3.2-1b", "olmoe-1b-7b", "xlstm-1.3b", "zamba2-2.7b"]
pytestmark = pytest.mark.usefixtures("one_thread")


def _reference_exit(main, argv, monkeypatch):
    monkeypatch.setattr(sys, "argv", ["launch"] + argv)
    with pytest.raises(SystemExit) as e:
        main()
    return str(e.value)


@pytest.mark.parametrize("arch", ["hubert-xlarge", "phi-3-vision-4.2b"])
def test_train_refuses_frontend_archs_as_the_reference(arch, monkeypatch,
                                                       tmp_path):
    argv = ["--arch", arch, "--steps", "1", "--ckpt", str(tmp_path)]
    want = _reference_exit(jtrain.main, argv, monkeypatch)
    with pytest.raises(SystemExit) as e:
        ttrain.main(argv + ["--device", "cpu"])
    # the reference's message, naming the port's drivers for its own
    assert str(e.value) == want.replace(
        "examples/ drivers",
        "the port's example drivers (examples/*_torch.py)")
    assert "frontend" in want and str(e.value) != want


@pytest.mark.parametrize("arch", TRAIN_ARCHS)
def test_train_launcher_trains_the_new_families(arch, tmp_path):
    runner = ttrain.main(["--arch", arch, "--steps", "3", "--batch", "4",
                          "--seq", "16", "--device", "cpu", "--ckpt",
                          str(tmp_path), "--ckpt-every", "2"])
    assert len(runner.metrics_log) == 3
    assert all(np.isfinite(m["loss"]) and np.isfinite(m["grad_norm"])
               for m in runner.metrics_log)
    assert runner.ckpt.all_steps() == [2, 3]


class _StubEngine:
    """Records what the reference launcher submits; serves nothing."""
    submitted = []

    def __init__(self, *a, **kw):
        self.steps_run = 0
        _StubEngine.submitted = []

    def submit(self, r):
        _StubEngine.submitted.append(r)
        r.out = []

    def run(self):
        return list(_StubEngine.submitted)


@pytest.mark.parametrize("arch", SERVE_ARCHS)
def test_serve_launcher_serves_the_reference_requests(arch, monkeypatch):
    argv = ["--arch", arch, "--requests", "5", "--slots", "2",
            "--max-new", "4"]
    monkeypatch.setattr(sys, "argv", ["serve"] + argv)
    monkeypatch.setattr(jserve, "ServeEngine", _StubEngine)
    monkeypatch.setattr(jserve, "init_params", lambda key, cfg: None)
    jserve.main()
    want = _StubEngine.submitted
    engine, reqs = tserve.main(argv + ["--device", "cpu"])
    assert engine.device.type == "cpu" and not engine.capture
    assert len(reqs) == len(want) == 5
    vocab = engine.cfg.vocab
    for got, ref in zip(reqs, want):
        assert got.uid == ref.uid and got.max_new_tokens == ref.max_new_tokens
        assert got.prompt.dtype == ref.prompt.dtype
        np.testing.assert_array_equal(got.prompt, ref.prompt)
        assert len(got.out) == 4
        assert all(0 <= t < vocab for t in got.out)


def test_serve_refuses_an_encoder_as_the_reference(monkeypatch):
    argv = ["--arch", "hubert-xlarge"]
    want = _reference_exit(jserve.main, argv, monkeypatch)
    with pytest.raises(SystemExit) as e:
        tserve.main(argv + ["--device", "cpu"])
    assert str(e.value) == want and "no decode step" in want


@pytest.mark.parametrize("launcher", ["train", "serve"])
def test_launchers_need_cuda_unless_told_cpu(launcher, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device exists: the default device is valid")
    main, argv = {"train": (ttrain.main, ["--arch", "zamba2-2.7b", "--steps",
                                          "1", "--ckpt", str(tmp_path)]),
                  "serve": (tserve.main, ["--arch", "xlstm-1.3b"])}[launcher]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        main(argv)
