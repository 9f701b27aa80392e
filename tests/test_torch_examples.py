"""The port's four example entry points (``examples/*_torch.py``) on the
CPU: each ``main`` at a tiny size with ``--device cpu`` (their own asserts
hold), each refusing to start without a card unless asked for the CPU, and
the LLM example stopped at step k and resumed to 2k from its checkpoints
with its frozen masks kept."""
import importlib.util
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from _train_families import one_thread  # noqa: E402,F401

ROOT = Path(__file__).resolve().parents[1]
NAMES = ("quickstart", "serve_batched", "llm_sparse_train", "lenet_pipeline")
TINY = {
    "quickstart": [],
    "serve_batched": [],
    "llm_sparse_train": ["--layers", "2", "--d-model", "64", "--d-ff", "128",
                         "--vocab", "256", "--batch", "4", "--seq", "32"],
    "lenet_pipeline": ["--steps", "4", "--finetune-steps", "4"],
}
# one intra-op thread a test: the workers of a parallel run share the cores
pytestmark = pytest.mark.usefixtures("one_thread")


def _example(name):
    path = ROOT / "examples" / f"{name}_torch.py"
    spec = importlib.util.spec_from_file_location(f"{name}_torch", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("name", NAMES)
def test_example_main_runs_on_the_cpu(name, tmp_path):
    argv = ["--device", "cpu"] + TINY[name]
    if name == "llm_sparse_train":
        argv += ["--steps", "4", "--prune-at", "2", "--ckpt",
                 str(tmp_path / "ck")]
    out = _example(name).main(argv)
    if name == "quickstart":
        assert set(out) >= {"kernel_vs_plain", "compressed_vs_oracle",
                            "kernel_vs_twin", "lenet_vs_oracle"}
    elif name == "serve_batched":
        assert len(out) == 5 and all(r.out for r in out)
    elif name == "llm_sparse_train":
        assert out["max_pruned"] == 0.0
    else:
        assert [r["strategy"] for r in out.rows][-1] == "proposed_realised"


@pytest.mark.parametrize("name", NAMES)
def test_example_needs_a_card_unless_asked_for_the_cpu(name, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        _example(name).main([])


def test_llm_example_resumes_from_its_last_step_with_the_masks_kept(tmp_path):
    """Stopped at step 4 (pruned at 2, a checkpoint every 2 steps), then run
    to 8: both runners restore step 4, the weights pruned by step 4 stay
    exactly zero, the masks derived after the restore are the first run's,
    and the second run trains steps 5-8 only."""
    mod = _example("llm_sparse_train")
    argv = ["--device", "cpu", *TINY["llm_sparse_train"], "--prune-at", "2",
            "--ckpt-every", "2", "--ckpt", str(tmp_path / "ck")]
    first = mod.main(argv + ["--steps", "4"])
    second = mod.main(argv + ["--steps", "8"])
    assert len(first["sparse_losses"]) == 2
    assert len(second["sparse_losses"]) == 4
    # the dense runner restored step 4, past its 2 steps, and ran none
    assert all(v != v for v in second["dense_losses"])
    for key, m in first["masks"].items():
        assert torch.equal(second["masks"][key], m), key
        w = second["params"]["blocks"]["mlp"][key]["w"]
        assert not w[~m].any(), key
        assert w[m].abs().min() > 0, key
    assert second["max_pruned"] == 0.0
