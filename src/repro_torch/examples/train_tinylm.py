"""End-to-end training driver: train a small LM with the port's stack —
AdamW with a cosine schedule, the deterministic data pipeline,
asynchronous checkpoints and crash recovery — on the card (every
attention through the ``flash_attention`` kernel), or on the CPU with
``--device cpu``.

The default is a ~7M-parameter qwen-family model for 200 steps;
``--arch`` selects any registered architecture (its smoke config, scaled
down); ``--params-100m`` scales to ~100M parameters.

Run:  PYTHONPATH=src python -m repro_torch.examples.train_tinylm [--steps 200]
      PYTHONPATH=src python -m repro_torch.examples.train_tinylm --device cpu
"""

import argparse
import logging
import os
import tempfile

from repro_torch.configs import base as cb
from repro_torch.data.pipeline import DataConfig
from repro_torch.optim import adamw
from repro_torch.train.trainer import Trainer, TrainerConfig


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen1.5-0.5b")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--params-100m", action="store_true",
                    help="~100M-param configuration (use the card)")
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_tinylm"))
    ap.add_argument("--device", default=None,
                    help="the card when omitted; 'cpu' runs on the CPU")
    args = ap.parse_args(argv)

    cfg = cb.get(args.arch, smoke=True)
    if args.params_100m:
        cfg = cfg.scaled(n_layers=8, d_model=768, n_heads=12, n_kv_heads=12,
                         d_ff=2048, vocab_size=32000)
    else:
        cfg = cfg.scaled(d_model=128, d_ff=384, n_layers=4,
                         vocab_size=2048)
    tc = TrainerConfig(total_steps=args.steps, ckpt_every=50, log_every=10,
                       ckpt_dir=args.ckpt_dir)
    opt = adamw.AdamWConfig(lr=1e-3, warmup_steps=20,
                            total_steps=args.steps)
    dc = DataConfig(global_batch=args.batch, seq_len=args.seq, seed=0)
    trainer = Trainer(cfg, tc, opt_cfg=opt, data_cfg=dc, device=args.device)
    print(f"arch={cfg.name} params~{cfg.param_count()/1e6:.1f}M "
          f"device={trainer.device}")

    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(name)s %(message)s")
    out = trainer.run()
    print(f"\nfinished at step {out['final_step']}; "
          f"loss {float(out['metrics']['loss']):.4f}; "
          f"restarts {out['restarts']}; stragglers {out['stragglers']}")
    trainer.checkpointer.close()
    return out


if __name__ == "__main__":
    main()
