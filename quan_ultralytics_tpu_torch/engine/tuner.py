"""Hyperparameter tuner: random-mutation evolution (counterpart of the JAX
package's ``engine/tuner.py``; reference engine/tuner.py Tuner).

Mutate the best hyperparameters so far within bounded gains, train briefly,
keep the fitter. The search space mirrors the reference's (lr0, lrf,
momentum, weight_decay, warmup, loss gains, augmentation gains), and the
draws come from ``random.Random(seed)`` in the JAX package's order, so one
seed and one fitness function give the JAX tuner's history.
"""

from __future__ import annotations

import json
import random
from pathlib import Path
from typing import Callable, Dict, List, Tuple

# (min, max) of each gene: the reference tuner's space
SPACE: Dict[str, Tuple[float, float]] = {
    "lr0": (1e-5, 1e-1),
    "lrf": (0.01, 1.0),
    "momentum": (0.6, 0.98),
    "weight_decay": (0.0, 0.001),
    "warmup_epochs": (0.0, 5.0),
    "box": (0.02, 10.0),
    "cls": (0.2, 4.0),
    "dfl": (0.4, 6.0),
    "hsv_h": (0.0, 0.1),
    "hsv_s": (0.0, 0.9),
    "hsv_v": (0.0, 0.9),
    "degrees": (0.0, 45.0),
    "translate": (0.0, 0.9),
    "scale": (0.0, 0.9),
    "fliplr": (0.0, 1.0),
    "mosaic": (0.0, 1.0),
}


def mutate(hyp: Dict[str, float], rng: random.Random, mutation: float = 0.8,
           sigma: float = 0.2) -> Dict[str, float]:
    """The reference's Tuner._mutate: each gene mutates with probability
    ``mutation`` by a gaussian factor, clipped to its bounds."""
    out = dict(hyp)
    for k, (lo, hi) in SPACE.items():
        if k in out and rng.random() < mutation:
            factor = 1.0 + rng.gauss(0, sigma)
            out[k] = min(max(out[k] * factor if out[k] else (lo + hi) * 0.05 * factor, lo), hi)
    return out


class Tuner:
    """``Tuner(train_fn, base_hyp)(iterations)``: ``train_fn(hyp)`` returns a
    fitness (higher is better); ``tune_results.json`` and
    ``best_hyperparameters.json`` in ``save_dir`` are rewritten every iteration."""

    def __init__(self, train_fn: Callable[[Dict[str, float]], float],
                 base_hyp: Dict[str, float], save_dir: str = "runs/tune", seed: int = 0):
        self.train_fn = train_fn
        self.base_hyp = {k: v for k, v in base_hyp.items() if k in SPACE}
        self.dir = Path(save_dir)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.rng = random.Random(seed)
        self.history: List[Dict] = []

    def __call__(self, iterations: int = 30) -> Dict[str, float]:
        best_hyp, best_fit = dict(self.base_hyp), float("-inf")
        for it in range(iterations):
            hyp = mutate(best_hyp, self.rng) if it else dict(self.base_hyp)
            fitness = float(self.train_fn(hyp))
            self.history.append({"iteration": it, "fitness": fitness, **hyp})
            if fitness > best_fit:
                best_fit, best_hyp = fitness, hyp
            (self.dir / "tune_results.json").write_text(json.dumps(self.history, indent=2))
            (self.dir / "best_hyperparameters.json").write_text(
                json.dumps({"fitness": best_fit, **best_hyp}, indent=2))
        return best_hyp
