"""The PyTorch twins of the examples (``examples/torch_*.py``) run end to
end on the CPU at a tiny size; each asserts its own invariants (the quality
path equals the planned path bit for bit, the lifecycle equals a fresh
build, save/load answers alike, the retrieval step is a log-distribution
off the plain one)."""

import runpy
from pathlib import Path

import pytest
import torch

EXAMPLES = Path(__file__).resolve().parents[1] / "examples"


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _main(name):
    return runpy.run_path(str(EXAMPLES / f"{name}.py"), run_name="example")["main"]


def test_torch_quickstart_runs_on_cpu(capsys):
    recall = _main("torch_quickstart")(["--device", "cpu", "--n", "1024"])
    out = capsys.readouterr().out
    assert "bit-identical" in out and "save/load round-trip" in out
    assert 0.0 <= recall <= 1.0


def test_torch_streaming_updates_runs_on_cpu(capsys):
    recall = _main("torch_streaming_updates")(["--device", "cpu", "--n", "2048"])
    out = capsys.readouterr().out
    assert "compact() == fresh build (bit-identical)" in out
    assert recall > 0.5


def test_torch_weighted_knn_classify_runs_on_cpu(capsys):
    acc_unw, acc_w, acc_alsh = _main("torch_weighted_knn_classify")(
        ["--device", "cpu", "--n", "4000"])
    assert "ALSH weighted kNN" in capsys.readouterr().out
    assert acc_w >= acc_unw and acc_alsh > 0.5


def test_torch_lm_retrieval_serve_runs_on_cpu(capsys):
    tokens = _main("torch_lm_retrieval_serve")(["--device", "cpu", "--batch", "2",
                                                "--prompt-len", "16", "--gen-len", "4"])
    out = capsys.readouterr().out
    assert "[serve] datastore index: n=8192 d=16" in out and "ALSH-retrieval" in out
    assert tokens["plain"].shape == tokens["ALSH-retrieval"].shape == (2, 4)


def test_torch_train_small_runs_on_cpu(capsys, tmp_path):
    """Two steps of the small model: finite losses and a committed step-2
    checkpoint that holds the training state's leaves."""
    from repro_torch import ckpt

    losses = _main("torch_train_small")(["--device", "cpu", "--steps", "2", "--seq-len", "32",
                                         "--global-batch", "2", "--ckpt-dir", str(tmp_path)])
    assert len(losses) == 2 and all(torch.isfinite(torch.tensor(losses)))
    assert "[train_small] loss" in capsys.readouterr().out
    assert ckpt.latest_step(str(tmp_path)) == 2
    back = ckpt.restore_checkpoint(str(tmp_path), 2, ["opt/step", "params/embed/table",
                                                     "opt/m/embed/table"])
    assert int(back["opt/step"]) == 2 and back["params/embed/table"].shape == (4096, 384)
    assert back["opt/m/embed/table"].any()  # the step moved the moments


def test_torch_examples_need_the_card_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for name, argv in (("torch_quickstart", ["--n", "64"]),
                       ("torch_streaming_updates", ["--n", "64"]),
                       ("torch_weighted_knn_classify", ["--n", "64"]),
                       ("torch_lm_retrieval_serve", ["--batch", "1"]),
                       ("torch_train_small", ["--steps", "1"])):
        with pytest.raises(RuntimeError, match='device="cpu"'):
            _main(name)(argv)
