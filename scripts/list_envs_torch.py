"""List the task environments registered in the PyTorch/CUDA port.

The port's counterpart of ``scripts/list_envs.py``: the same table, one env
of each id made on ``--device`` (the card by default; ``--device cpu`` runs
on the CPU).

Usage: python scripts/list_envs_torch.py [--device cpu]
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))  # repo root, so the script runs from anywhere


def main(argv: list[str] | None = None) -> list[str]:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--device", default="cuda", help="cuda (default; raises without a card) or cpu")
    args = p.parse_args(argv)

    from tacex_tpu_torch import envs

    ids = envs.registered_envs()
    print(f"{'env id':<45} {'class':<25} num_envs  obs")
    for env_id in ids:
        env = envs.make(env_id, num_envs=1, device=args.device)
        obs_desc = getattr(env.cfg, "obs_mode", "-")
        print(f"{env_id:<45} {type(env).__name__:<25} {env.cfg.num_envs:<8} {obs_desc}")
    return ids


if __name__ == "__main__":
    main()
