"""The port's checkpoints and fault-tolerant trainer on the CPU
(``repro_torch.checkpoint.ckpt``, ``repro_torch.train.trainer``, the
``train_tinylm`` example): the reference's directory format, a crash and
restore that ends bit-equal to an uninterrupted run (as
``tests/test_fault_tolerance.py`` asserts for the reference), straggler
detection."""

from __future__ import annotations

import json
import os

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.checkpoint import ckpt as jckpt
from repro_torch.checkpoint import ckpt
from repro_torch.configs import base as cb
from repro_torch.data.pipeline import DataConfig
from repro_torch.examples import train_tinylm
from repro_torch.optim import adamw
from repro_torch.train.trainer import Trainer, TrainerConfig


def _tree() -> dict:
    gen = torch.Generator().manual_seed(0)
    return {"params": {"layers.0.w": torch.randn(3, 4, generator=gen),
                       "embed.table": torch.randn(5, 2, generator=gen)
                       .to(torch.bfloat16)},
            "opt": {"m": {"layers.0.w": torch.randn(3, 4, generator=gen)},
                    "step": torch.tensor(7, dtype=torch.int32)}}


def _leaves(tree: dict) -> list:
    return [leaf for _, leaf in ckpt._flatten(tree)]


def _zeros_like(tree: dict) -> dict:
    return {k: _zeros_like(v) if isinstance(v, dict) else torch.zeros_like(v)
            for k, v in tree.items()}


def test_checkpoint_roundtrip_and_format(tmp_path):
    tree = _tree()
    d = ckpt.save(str(tmp_path), 12, tree)
    assert os.path.basename(d) == "step_00000012"
    assert sorted(os.listdir(d)) == ["DONE"] + \
        [f"leaf_{i:05d}.npy" for i in range(4)] + ["tree.json"]
    meta = json.load(open(os.path.join(d, "tree.json")))
    assert meta["treedef"] == ["opt/m/layers.0.w", "opt/step",
                               "params/embed.table", "params/layers.0.w"]
    assert [leaf["dtype"] for leaf in meta["leaves"]] == \
        ["float32", "int32", "bfloat16", "float32"]
    assert np.load(os.path.join(d, "leaf_00002.npy")).dtype == np.uint16
    assert ckpt.latest_step(str(tmp_path)) == 12
    back = ckpt.restore(str(tmp_path), 12, _zeros_like(tree))
    for a, b in zip(_leaves(back), _leaves(tree)):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_the_reference_restores_a_port_checkpoint(tmp_path):
    """The leaves' order and the bf16 bit pattern are the reference's: its
    own ``restore`` reads a checkpoint the port wrote."""
    tree = _tree()
    ckpt.save(str(tmp_path), 3, tree)
    like = {"params": {"layers.0.w": jnp.zeros((3, 4), jnp.float32),
                       "embed.table": jnp.zeros((5, 2), jnp.bfloat16)},
            "opt": {"m": {"layers.0.w": jnp.zeros((3, 4), jnp.float32)},
                    "step": jnp.zeros((), jnp.int32)}}
    got = jckpt.restore(str(tmp_path), 3, like)
    table = tree["params"]["embed.table"].float().numpy()
    assert np.asarray(got["params"]["embed.table"]).dtype == \
        ml_dtypes.bfloat16
    assert np.array_equal(np.asarray(got["params"]["embed.table"],
                                     np.float32), table)
    assert np.array_equal(np.asarray(got["params"]["layers.0.w"]),
                          tree["params"]["layers.0.w"].numpy())
    assert int(got["opt"]["step"]) == 7


def test_uncommitted_and_mismatched_checkpoints(tmp_path):
    tree = _tree()
    ckpt.save(str(tmp_path), 2, tree)
    os.makedirs(tmp_path / "step_00000009.tmp")          # a torn write
    os.makedirs(tmp_path / "step_00000011")              # no DONE marker
    assert ckpt.latest_step(str(tmp_path)) == 2
    assert ckpt.latest_step(str(tmp_path / "missing")) is None
    with pytest.raises(FileNotFoundError):
        ckpt.restore(str(tmp_path), 11, tree)
    wrong = _zeros_like(tree)
    wrong["params"]["layers.0.w"] = torch.zeros(4, 3)
    with pytest.raises(ValueError, match="layers.0.w"):
        ckpt.restore(str(tmp_path), 2, wrong)
    extra = _zeros_like(tree)
    extra["params"]["head.w"] = torch.zeros(1)
    with pytest.raises(ValueError, match="leaves"):
        ckpt.restore(str(tmp_path), 2, extra)


def test_async_checkpointer_copies_on_submit_and_keeps_the_newest(tmp_path):
    tree = _tree()
    saver = ckpt.AsyncCheckpointer(str(tmp_path), keep=2)
    for step in (1, 2, 3):
        submitted = tree["params"]["layers.0.w"].clone()
        saver.submit(step, tree)
        tree["params"]["layers.0.w"].add_(1.0)      # the step's in-place
    saver.close()
    assert sorted(os.listdir(tmp_path)) == ["step_00000002",
                                            "step_00000003"]
    back = ckpt.restore(str(tmp_path), 3, _zeros_like(tree))
    assert torch.equal(back["params"]["layers.0.w"], submitted)


def _trainer(tmp_path, name: str, **kw) -> Trainer:
    cfg = cb.get("qwen1.5-0.5b", smoke=True)
    tc = TrainerConfig(total_steps=kw.pop("steps", 8), ckpt_every=2,
                       log_every=100, ckpt_dir=str(tmp_path / name), **kw)
    return Trainer(cfg, tc, data_cfg=DataConfig(global_batch=4, seq_len=32),
                   device="cpu")


def _final_params(tr: Trainer, step: int) -> dict:
    model, opt, _ = tr.init_state()
    like = {"params": dict(model.named_parameters()), "opt": opt}
    return ckpt.restore(tr.tc.ckpt_dir, step, like)


def test_restart_from_checkpoint_after_injected_failure(tmp_path):
    """A failure at step 5 restores step 4 and replays 4..8 on the same
    data: the final params equal an uninterrupted run's bit for bit."""
    tr = _trainer(tmp_path, "ck")
    out = tr.run(fail_at=5)
    tr.checkpointer.close()
    assert out["final_step"] == 8 and out["restarts"] == 1
    tr2 = _trainer(tmp_path, "ck2")
    out2 = tr2.run()
    tr2.checkpointer.close()
    assert out2["restarts"] == 0
    assert float(out["metrics"]["loss"]) == float(out2["metrics"]["loss"])
    a, b = _final_params(tr, 8), _final_params(tr2, 8)
    for x, y in zip(_leaves(a), _leaves(b)):
        assert torch.equal(x, y)
    assert int(a["opt"]["step"]) == 8


def test_trainer_end_to_end_with_microbatches_and_compression(tmp_path):
    tr = _trainer(tmp_path, "ck", steps=4, n_microbatches=2,
                  compress_grads=True)
    first = tr.init_state()[0]
    w0 = first.layers[0].attn.wq.w.detach().clone()
    out = tr.run()
    tr.checkpointer.close()
    assert out["final_step"] == 4 and out["restarts"] == 0
    assert sorted(out["metrics"]) == ["aux", "grad_norm", "loss", "lr",
                                      "nll"]
    assert np.isfinite(float(out["metrics"]["loss"]))
    assert sorted(os.listdir(tr.tc.ckpt_dir)) == ["step_00000002",
                                                  "step_00000004"]
    state = _final_params(tr, 4)
    assert sorted(state["opt"]) == ["grad_err", "m", "step", "v"]
    assert int(state["opt"]["step"]) == 4
    assert not torch.equal(state["params"]["layers.0.attn.wq.w"], w0)
    assert len(tr.step_times) == 4


def test_trainer_gives_up_after_max_restarts(tmp_path):
    tr = _trainer(tmp_path, "ck", steps=2, max_restarts=0)
    with pytest.raises(RuntimeError, match="injected"):
        tr.run(fail_at=1)
    tr.checkpointer.close()


def test_straggler_detection(tmp_path):
    tr = _trainer(tmp_path, "ck", steps=1, straggler_factor=2.0)
    for t in [0.1] * 10:
        tr._straggler_check(0, t)
    tr._straggler_check(11, 0.5)      # 5x median -> straggler
    assert tr.straggler_events == [11]
    tr.checkpointer.close()


def test_trainer_defaults(tmp_path):
    cfg = cb.get("qwen1.5-0.5b", smoke=True)
    tr = Trainer(cfg, TrainerConfig(total_steps=7,
                                    ckpt_dir=str(tmp_path / "ck")),
                 device="cpu")
    assert tr.opt_cfg == adamw.AdamWConfig(total_steps=7)
    assert tr.data_cfg == DataConfig(global_batch=8, seq_len=128, seed=0)
    assert tr.device == torch.device("cpu")
    tr.checkpointer.close()


def test_train_tinylm_example_on_the_cpu(tmp_path):
    out = train_tinylm.main(["--device", "cpu", "--steps", "3", "--batch",
                             "2", "--seq", "16", "--ckpt-dir",
                             str(tmp_path / "tiny")])
    assert out["final_step"] == 3 and np.isfinite(
        float(out["metrics"]["loss"]))
    assert os.listdir(tmp_path / "tiny") == ["step_00000003"]
