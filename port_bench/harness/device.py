"""The card a run uses: the check that it is there, and what the result
line says of it."""

from __future__ import annotations

import subprocess
import sys
from typing import Optional


def require_cards(chips: int) -> None:
    """Exits with code 2, printing no result, where the cell's cards are missing."""
    import torch

    if not torch.cuda.is_available():
        print("port_bench: torch.cuda.is_available() is False: this benchmark runs on the card",
              file=sys.stderr)
        raise SystemExit(2)
    if torch.cuda.device_count() < chips:
        print(f"port_bench: the cell needs {chips} cards, torch sees "
              f"{torch.cuda.device_count()}", file=sys.stderr)
        raise SystemExit(2)


def card_line() -> Optional[str]:
    """``nvidia-smi``'s name and power limit of card 0; None where it cannot say."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=60)
    except (OSError, subprocess.TimeoutExpired):
        return None
    lines = out.stdout.strip().splitlines()
    return lines[0].strip() if out.returncode == 0 and lines else None


def info(chips: int, peak_bytes: int) -> dict:
    import torch

    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": chips,
            "memory_peak_bytes": int(peak_bytes)}
