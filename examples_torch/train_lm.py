"""End-to-end example: train the ~124M-parameter GPT-2-class model with
the port (counterpart of examples/train_lm.py).

    PYTHONPATH=src python examples_torch/train_lm.py --steps 300
    PYTHONPATH=src python examples_torch/train_lm.py --smoke --device cpu

On the card by default (``--device cpu`` runs the plain torch on the
CPU; ``--smoke`` the reduced config).  The microbatched, remat'd train
step, warmup + cosine LR, the deterministic data pipeline, async atomic
checkpoints, supervisor restart and the straggler monitor, through
``repro_torch.launch.train.run``.  ``--fail-at N`` injects a simulated
node failure before step N to show the recovery: the supervisor restores
the last checkpoint and replays the same batches.
"""
import argparse
import sys
import tempfile
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.launch.train import run  # noqa: E402
from repro_torch.models.params import count_params  # noqa: E402
from repro_torch.models.registry import (  # noqa: E402
    get_config,
    get_smoke_config,
)
from repro_torch.runtime.supervisor import SimulatedFailure  # noqa: E402
from repro_torch.train.step import TrainHParams  # noqa: E402


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--microbatches", type=int, default=2)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--fail-at", type=int, default=0)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--ckpt-dir", default=None,
                    help="default: a temporary directory, removed at exit")
    args = ap.parse_args()

    cfg = (get_smoke_config("paper-gpt2-124m") if args.smoke
           else get_config("paper-gpt2-124m"))
    hp = TrainHParams(
        base_lr=6e-4, warmup_steps=20, total_steps=args.steps,
        num_microbatches=args.microbatches,
    )
    print(f"model={cfg.name} params={count_params(cfg):,}")

    def failure_hook(step):
        if args.fail_at and step == args.fail_at:
            args.fail_at = 0  # only once
            raise SimulatedFailure(f"injected node failure at step {step}")

    with tempfile.TemporaryDirectory(prefix="train_lm-") as tmp:
        t0 = time.perf_counter()
        res = run(cfg, hp, batch=args.batch, seq=args.seq, steps=args.steps,
                  ckpt_dir=args.ckpt_dir or tmp, ckpt_every=args.ckpt_every,
                  device=args.device, failure_hook=failure_hook)
    st = res.supervisor.stats
    print(f"\ntrained {st.steps_run} steps in "
          f"{time.perf_counter() - t0:.0f}s  "
          f"(failures={st.failures}, restores={st.restores})")


if __name__ == "__main__":
    main()
