"""Counter-based early stopping on val dice (counterpart of
stf_unet_tpu/train/early_stop.py; ref:train_utils/early_stopping.py)."""

from __future__ import annotations


class EarlyStopping:
    def __init__(self, patience: int = 10, verbose: bool = False):
        self.patience = patience
        self.counter = 0
        self.best_score = None
        self.early_stop = False
        self.verbose = verbose

    def step(self, metric: float) -> bool:
        if self.best_score is None:
            self.best_score = metric
            return False
        if metric <= self.best_score:
            self.counter += 1
            if self.verbose:
                print(f"EarlyStopping: {self.counter}/{self.patience} no "
                      f"improvement.")
            if self.counter >= self.patience:
                self.early_stop = True
                return True
        else:
            self.best_score = metric
            self.counter = 0
        return False

    def state_dict(self) -> dict:
        return {"counter": self.counter, "best_score": self.best_score,
                "early_stop": self.early_stop}

    def load_state_dict(self, d: dict) -> None:
        self.counter = d["counter"]
        self.best_score = d["best_score"]
        self.early_stop = d["early_stop"]
