"""Weight conversion utilities; counterpart of ``refiners_tpu/conversion/utils.py``.

Converts upstream checkpoints (diffusers, transformers, original repos) into
the refiners key layout, which the port's chains reproduce. The JAX package
also transposes every weight into its own layouts; the port's layouts ARE
torch's (Linear (out, in), Conv2d OIHW, ConvTranspose2d (in, out, kh, kw)),
so the ``op_*`` layout helpers keep their names and return their input.
"""

from __future__ import annotations

import hashlib
import os
import re
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Callable

import numpy as np
import torch

TensorOp = Callable[[torch.Tensor], torch.Tensor]


def as_tensor(value: Any) -> torch.Tensor:
    """A torch tensor of `value` (a tensor as it is, else through numpy)."""
    return value if isinstance(value, torch.Tensor) else torch.as_tensor(np.asarray(value))


def op_identity(x: torch.Tensor) -> torch.Tensor:
    return x


def op_linear(x: torch.Tensor) -> torch.Tensor:
    """torch Linear weight (out, in): the port's layout, unchanged."""
    return x


def op_conv(x: torch.Tensor) -> torch.Tensor:
    """torch Conv2d weight OIHW: the port's layout, unchanged."""
    return x


def op_conv_transpose(x: torch.Tensor) -> torch.Tensor:
    """torch ConvTranspose2d weight (in, out, kh, kw): the port's layout, unchanged."""
    return x


@dataclass
class Rule:
    """One renaming rule: regex over source keys → target template + layout op.

    The template may reference regex groups as ``\\1``/``\\g<name>``. Callable
    templates receive the match object and return the target key (or None to
    skip the key).
    """

    pattern: str
    target: str | Callable[[re.Match[str]], str | None]
    op: TensorOp = op_identity

    def apply(self, key: str) -> tuple[str | None, TensorOp] | None:
        """None when `key` does not match; else the target key (None for a
        key the rule skips) and the layout op."""
        m = re.fullmatch(self.pattern, key)
        if m is None:
            return None
        if callable(self.target):
            return self.target(m), self.op
        return m.expand(self.target), self.op


@dataclass
class WeightRecipe:
    """Declarative key-translation table.

    Order matters: the first matching rule wins. Keys a rule skips are
    dropped; keys matching no rule are dropped when `strict` is False, or
    raise otherwise. (The JAX package's raises under `strict` for the keys
    its rules skip too.)
    """

    rules: list[Rule] = field(default_factory=list)
    strict: bool = True

    def translate(self, state: dict[str, Any]) -> dict[str, torch.Tensor]:
        out: dict[str, torch.Tensor] = {}
        for key, value in state.items():
            hit = None
            for rule in self.rules:
                hit = rule.apply(key)
                if hit is not None:
                    break
            if hit is None:
                if self.strict:
                    raise KeyError(f"no conversion rule for key {key!r}")
                continue
            target, op = hit
            if target is not None:
                out[target] = op(as_tensor(value))
        return out


@dataclass
class KeyMapRecipe:
    """Suffix-aware key translation table.

    `key_map` maps source key *stems* (without the ``.weight``/``.bias``
    suffix) to target stems in the refiners layout. Unknown keys are dropped.
    Values pass through as they come, apart from `tensor_reshapes` (LDM's 1×1
    convolutions that are Linears here, a class token stored flat).
    """

    key_map: dict[str, str]
    key_prefix: str = ""
    key_aliases: dict[str, str] = field(default_factory=dict)
    tensor_reshapes: dict[str, tuple[int, ...]] = field(default_factory=dict)

    def translate(self, state: dict[str, Any]) -> dict[str, Any]:
        out: dict[str, Any] = {}
        for key, value in state.items():
            suffix = next(s for s in (".weight", ".bias", "") if key.endswith(s))
            stem = key.removesuffix(suffix).removeprefix(self.key_prefix)
            stem = self.key_aliases.get(stem, stem)
            target = self.key_map.get(stem)
            if target is None:
                continue
            out[target + suffix] = value
        for key, shape in self.tensor_reshapes.items():
            if key in out:
                out[key] = torch.reshape(as_tensor(out[key]).contiguous(), shape)
        return out

    def convert(self, state: dict[str, Any], target: torch.nn.Module, strict: bool = True) -> dict[str, torch.Tensor]:
        """Translate keys, then check them and their shapes against `target`."""
        from refiners_tpu_torch.conversion.refiners_compat import convert_refiners_state_dict

        return convert_refiners_state_dict(self.translate(state), target, strict=strict)


def convert_state_dict(
    state: dict[str, Any], recipe: WeightRecipe, dtype: torch.dtype | None = None
) -> dict[str, torch.Tensor]:
    """`recipe.translate(state)`, floating tensors cast to `dtype` when given."""
    converted = recipe.translate(state)
    if dtype is not None:
        converted = {k: v.to(dtype) if v.is_floating_point() else v for k, v in converted.items()}
    return converted


@dataclass
class Hub:
    """Weight registry entry: remote URL + sha256 + local cache path.
    Downloads need egress; without it the file must already be at
    `local_path`."""

    repo_id: str
    filename: str
    expected_sha256: str | None = None
    revision: str = "main"
    download_url: str | None = None

    @property
    def url(self) -> str:
        if self.download_url is not None:
            return self.download_url
        return f"https://huggingface.co/{self.repo_id}/resolve/{self.revision}/{self.filename}"

    @classmethod
    def cache_dir(cls) -> Path:
        """``REFINERS_TPU_WEIGHTS``, else ``~/.cache/refiners_tpu``: the JAX
        package's cache, shared for downloads (their layouts are the upstream's)."""
        return Path(os.environ.get("REFINERS_TPU_WEIGHTS", Path.home() / ".cache" / "refiners_tpu"))

    @property
    def local_path(self) -> Path:
        return self.cache_dir() / self.repo_id / self.filename

    def exists_locally(self) -> bool:
        return self.local_path.exists()

    def check_sha256(self) -> bool:
        if self.expected_sha256 is None:
            return True
        h = hashlib.sha256()
        with open(self.local_path, "rb") as f:
            for chunk in iter(lambda: f.read(1 << 20), b""):
                h.update(chunk)
        return h.hexdigest() == self.expected_sha256

    def download(self, force: bool = False) -> Path:
        if self.exists_locally() and not force:
            return self.local_path
        import urllib.request

        self.local_path.parent.mkdir(parents=True, exist_ok=True)
        try:
            urllib.request.urlretrieve(self.url, self.local_path)
        except Exception as e:  # no egress
            raise RuntimeError(
                f"cannot download {self.url}; place the file at {self.local_path} manually"
            ) from e
        if not self.check_sha256():
            self.local_path.unlink()
            raise RuntimeError(f"sha256 mismatch for {self.local_path}")
        return self.local_path


@dataclass
class Conversion:
    """source Hub → recipe → dtype cast → safetensors."""

    source: Hub
    target: Hub
    recipe: WeightRecipe
    dtype: torch.dtype | None = None

    def run(self) -> Path:
        from refiners_tpu_torch.fluxion.utils import load_from_safetensors, load_tensors, save_to_safetensors

        src = self.source.download()
        state = load_from_safetensors(src) if src.suffix == ".safetensors" else load_tensors(src)
        converted = convert_state_dict(state, self.recipe, dtype=self.dtype)
        self.target.local_path.parent.mkdir(parents=True, exist_ok=True)
        save_to_safetensors(self.target.local_path, converted)
        return self.target.local_path
