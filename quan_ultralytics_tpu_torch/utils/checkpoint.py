"""Where a run's checkpoints are (counterpart of the JAX package's
``utils/checkpoint.py``). The files are the JAX trainer's pickles, which
`engine.trainer.Trainer.save_checkpoint` writes too (`utils.weights.write_checkpoint`)
and `Trainer.restore_checkpoint` reads (`utils.weights.read_checkpoint`)."""

from __future__ import annotations

from pathlib import Path
from typing import Optional, Union


def latest(run_dir: Union[str, Path]) -> Optional[str]:
    """The most recent resumable checkpoint in a run directory: ``last.ckpt``,
    else the highest ``epoch{N}.ckpt``; None when there is none."""
    d = Path(run_dir)
    if not d.exists():
        return None
    if (d / "last.ckpt").exists():
        return str(d / "last.ckpt")
    cands = sorted(d.glob("epoch*.ckpt"),
                   key=lambda q: int(q.stem[5:]) if q.stem[5:].isdigit() else -1)
    return str(cands[-1]) if cands else None
