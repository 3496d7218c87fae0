"""Elastic end-to-end training on the PyTorch/CUDA port: grow mid-run,
shrink, survive a node failure — the control plane resizing a real
training job. The twin of ``elastic_train.py``.

Run:  PYTHONPATH=src python examples/torch_elastic_train.py [--device cpu]
          [--ckpt-dir DIR]
"""
import argparse
import tempfile

from repro_torch.launch.train import run_training


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--ckpt-dir", default=None,
                    help="where checkpoints go (a temporary directory if not given)")
    args = ap.parse_args()
    with tempfile.TemporaryDirectory() as tmp:
        res = run_training(
            "llama3.2-3b", steps=24, smoke=True,
            grow_at=6,        # MATCHGROW +4 chips -> rebind
            shrink_at=12,     # MATCHSHRINK -2 chips
            fail_at=18,       # node ejection (subtractive transform) + replacement
            ckpt_dir=args.ckpt_dir or tmp, ckpt_every=8, device=args.device,
        )
    print("\nevent log:")
    for e in res["events"]:
        print(f"  {e.kind:8s} chips {e.chips_before} -> {e.chips_after}  {e.detail}")
    print(f"losses: {res['losses'][0]:.4f} -> {res['losses'][-1]:.4f}")


if __name__ == "__main__":
    main()
