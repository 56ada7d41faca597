"""ForceCommit callback: refuse to train on a dirty git tree; counterpart of
``refiners_tpu/training_utils/forcecommit.py`` (the same ``git`` calls)."""

from __future__ import annotations

import subprocess
from pathlib import Path
from typing import TYPE_CHECKING, Any

from refiners_tpu_torch.training_utils.callback import Callback, CallbackConfig

if TYPE_CHECKING:
    from refiners_tpu_torch.training_utils.trainer import Trainer


class ForceCommitConfig(CallbackConfig):
    force_commit: bool = True
    repo_path: str = "."


class ForceCommit(Callback["Trainer[Any, Any]"]):
    def __init__(self, config: ForceCommitConfig) -> None:
        self.config = config

    def _is_dirty(self) -> bool:
        out = subprocess.run(
            ["git", "status", "--porcelain"], cwd=Path(self.config.repo_path), capture_output=True, text=True
        )
        return bool(out.stdout.strip())

    def current_commit(self) -> str:
        out = subprocess.run(
            ["git", "rev-parse", "HEAD"], cwd=Path(self.config.repo_path), capture_output=True, text=True
        )
        return out.stdout.strip()

    def on_train_begin(self, trainer: "Trainer[Any, Any]") -> None:
        if self.config.force_commit and self._is_dirty():
            raise RuntimeError(
                "Refusing to train: the git working tree is dirty. Commit your changes or set force_commit = false."
            )
