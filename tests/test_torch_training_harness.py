"""The port's training harness against the JAX package's, on the CPU.

- the data loader: equal batches without shuffle, the same multiset with
  it, the same validators, the collate rule and `len` under `drop_last`;
- checkpoint save → restore → continue, bit for bit equal to an
  uninterrupted run, with the JAX package's ``meta.json`` keys;
- `ForceCommit` on a clean and on a dirty git repository;
- the wandb and neptune callbacks, through a stub module in
  ``sys.modules``: the same keys logged at the same steps as the JAX
  callbacks; `load_hf_dataset` through a stub ``datasets``;
- Lion, Prodigy and AdamW8bit against optax over 5 steps;
- `apply_remat` / `remove_remat` against ``refiners_tpu.parallel.remat``,
  and the contexts of the forward kept for the recompute;
- one decoder training step of the full-width SD1.5 VAE (32×32 image: 16
  latent tokens, the mid-block's one head of d = 512) through both
  packages' `Trainer` with AdamW.

No ``wandb``, ``neptune`` or ``datasets`` is needed: stubs stand in.
"""

from __future__ import annotations

import json
import subprocess
import sys
import tomllib
import types
from pathlib import Path
from typing import Any

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import refiners_tpu.fluxion.layers as jfl
import refiners_tpu.training_utils as jtu
import refiners_tpu_torch.fluxion.layers as fl
import refiners_tpu_torch.training_utils as tu
from refiners_tpu.fluxion import manual_seed as jax_manual_seed
from refiners_tpu.foundationals.latent_diffusion.auto_encoder import Decoder as JaxDecoder
from refiners_tpu.foundationals.latent_diffusion.auto_encoder import Encoder as JaxEncoder
from refiners_tpu.parallel import remat as jax_remat
from refiners_tpu.training_utils import checkpointing as jax_checkpointing
from refiners_tpu.training_utils import forcecommit as jax_forcecommit
from refiners_tpu.training_utils import huggingface_datasets as jax_hf
from refiners_tpu.training_utils import neptune as jax_neptune
from refiners_tpu.training_utils import wandb as jax_wandb
from refiners_tpu_torch.conversion import load_jax_state_dict, nhwc_to_nchw
from refiners_tpu_torch.fluxion import manual_seed as port_manual_seed
from refiners_tpu_torch.foundationals.latent_diffusion.auto_encoder import Decoder, Encoder
from refiners_tpu_torch.parallel import Recompute, apply_remat, remove_remat
from refiners_tpu_torch.training_utils import huggingface_datasets as port_hf
from refiners_tpu_torch.training_utils import neptune as port_neptune
from refiners_tpu_torch.training_utils import wandb as port_wandb

# float32 on both sides over 5 steps: rounding of the same arithmetic only
OPTIMIZER_TOL = 1e-6
# the same small network on both sides: summation order only
REMAT_TOL = 1e-6
# logged losses and grad norms of the same float32 MLP steps in two frameworks
LOG_TOL = 1e-5
# the full-width VAE decoder step, float32 on both sides: the loss over
# 3072 pixels after ~30 convolutions (summation order, ≈1e-7 a product,
# amplified by the depth); each gradient relative to its own norm, floored
# at 1e-3 of the global norm (a few have an exact zero: the key projection's
# bias, to which the softmax is blind); the updated weights over the whole
# decoder. AdamW's first step lr·g/(|g| + eps) normalizes each element's
# gradient, its noise included: where |g| is within a decade or two of eps
# (1e-8), and the conv weights hold elements down to 1e-10, the two steps
# differ, by at most the step's bound 2·lr (measured over the decoder:
# 4.4e-5 relative to its weights, float32 on a CPU).
VAE_LOSS_TOL = 1e-5
VAE_GRAD_TOL = 1e-4
VAE_WEIGHT_TOL = 2e-4


@pytest.fixture(autouse=True, scope="module")
def _torch_threads() -> Any:
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _rel(got: np.ndarray, want: np.ndarray) -> float:
    return float(np.linalg.norm(np.asarray(got) - np.asarray(want)) / max(np.linalg.norm(np.asarray(want)), 1e-30))


# -- the data loader -------------------------------------------------------------------


def _item(i: int) -> np.ndarray:
    return np.full((2,), float(i), dtype=np.float32)


@pytest.mark.parametrize("batch_size,drop_last", [(1, False), (3, False), (3, True), (4, True)])
def test_data_loader_without_shuffle_gives_the_jax_batches(batch_size: int, drop_last: bool) -> None:
    kwargs = {"batch_size": batch_size, "shuffle": False, "drop_last": drop_last}
    want = list(jtu.create_data_loader(_item, 10, jtu.DataLoaderConfig(**kwargs)))
    loader = tu.create_data_loader(_item, 10, tu.DataLoaderConfig(**kwargs))
    got = list(loader)
    assert len(loader) == len(jtu.create_data_loader(_item, 10, jtu.DataLoaderConfig(**kwargs))) == len(got)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        if batch_size == 1:  # the item itself
            assert isinstance(g, np.ndarray)
            np.testing.assert_array_equal(g, w)
        else:  # the list of items
            assert isinstance(g, list) and len(g) == len(w)
            for a, b in zip(g, w):
                np.testing.assert_array_equal(a, b)


def test_data_loader_with_shuffle_gives_the_same_multiset_seeded_by_epoch() -> None:
    want = list(jtu.create_data_loader(_item, 10, jtu.DataLoaderConfig(batch_size=3)))
    loader = tu.create_data_loader(_item, 10, tu.DataLoaderConfig(batch_size=3), seed=5)
    first = list(loader)

    def values(batches: list[list[np.ndarray]]) -> list[float]:
        return sorted(float(item[0]) for batch in batches for item in batch)

    assert values(first) == values(want) == [float(i) for i in range(10)]
    order = [float(item[0]) for batch in first for item in batch]
    assert order == [float(item[0]) for batch in loader for item in batch]  # the same epoch: the same order
    loader.set_epoch(1)
    assert order != [float(item[0]) for batch in loader for item in batch]
    again = tu.create_data_loader(_item, 10, tu.DataLoaderConfig(batch_size=3), seed=5)
    assert order == [float(item[0]) for batch in again for item in batch]


def test_data_loader_collate_function() -> None:
    def collate(items: list[np.ndarray]) -> np.ndarray:
        return np.stack(items).sum(axis=0)

    want = list(jtu.create_data_loader(_item, 6, jtu.DataLoaderConfig(batch_size=2, shuffle=False), collate_fn=collate))
    got = list(tu.create_data_loader(_item, 6, tu.DataLoaderConfig(batch_size=2, shuffle=False), collate_fn=collate))
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


WORKERS = """
import torch
from refiners_tpu_torch.training_utils import DataLoaderConfig, create_data_loader

def item(i):
    return torch.full((2,), float(i))

config = DataLoaderConfig(batch_size=2, num_workers=2, prefetch_factor=2, persistent_workers=True, pin_memory=False)
loader = create_data_loader(item, 7, config, collate_fn=torch.stack, seed=4)
plain = create_data_loader(item, 7, DataLoaderConfig(batch_size=2), collate_fn=torch.stack, seed=4)
assert isinstance(loader, torch.utils.data.DataLoader) and len(loader) == 4
for epoch in range(2):  # persistent workers serve the second epoch
    loader.set_epoch(epoch)
    plain.set_epoch(epoch)
    assert [b.tolist() for b in loader] == [b.tolist() for b in plain]
print("ok", loader._iterator is not None)
"""


def test_data_loader_worker_processes() -> None:
    """``num_workers``, ``prefetch_factor`` and ``persistent_workers`` take
    effect (torch's loader) and give the batches of the in-process loader.
    In a process of its own: forking a process that runs JAX's threads may
    deadlock."""
    out = subprocess.run([sys.executable, "-c", WORKERS], capture_output=True, text=True, timeout=120, check=True)
    assert out.stdout.strip() == "ok True"


@pytest.mark.parametrize(
    "kwargs",
    [
        {"batch_size": 0},
        {"num_workers": -1},
        {"prefetch_factor": 2},  # needs num_workers > 0
        {"persistent_workers": True},  # needs num_workers > 0
        {"num_workers": 1, "prefetch_factor": 0},
    ],
)
def test_data_loader_config_refuses_what_the_jax_one_refuses(kwargs: dict[str, Any]) -> None:
    with pytest.raises(Exception):
        jtu.DataLoaderConfig(**kwargs)
    with pytest.raises(ValueError):
        tu.DataLoaderConfig(**kwargs)


def test_data_loader_config_fields_and_unknown_keys() -> None:
    port, jax_config = tu.DataLoaderConfig(), jtu.DataLoaderConfig()
    assert dict(port) == jax_config.model_dump()
    with pytest.raises(Exception):
        jtu.DataLoaderConfig(not_a_field=1)
    with pytest.raises(TypeError):
        tu.DataLoaderConfig(not_a_field=1)  # type: ignore[call-arg]
    with pytest.raises(AssertionError):
        tu.DatasetFromCallable(_item, 0)


# -- a small trainer on each side ---------------------------------------------------------

MLP_TOML = """
[clock]
verbose = false

[training]
device = "cpu"
duration = "2:epoch"
seed = 3
gradient_accumulation = "2:step"

[optimizer]
optimizer = "{optimizer}"
learning_rate = {lr}

[lr_scheduler]
type = "ConstantLR"
warmup = "2:step"

[model]
requires_grad = true
"""


def _mlp_data() -> list[tuple[np.ndarray, np.ndarray]]:
    rs = np.random.RandomState(0)
    return [(rs.randn(10).astype(np.float32), rs.randn(10).astype(np.float32)) for _ in range(8)]


def _stack_pairs(items: list[tuple[Any, Any]]) -> tuple[torch.Tensor, torch.Tensor]:
    return torch.stack([torch.as_tensor(x) for x, _ in items]), torch.stack([torch.as_tensor(y) for _, y in items])


class PortMlpConfig(tu.BaseConfig):
    model: tu.ModelConfig
    checkpoint: tu.CheckpointConfig | None = None
    wandb: tu.WandbConfig | None = None
    neptune: tu.NeptuneConfig | None = None


class PortMlpTrainer(tu.Trainer[PortMlpConfig, Any], tu.WandbMixin, tu.NeptuneMixin):
    """An MLP on 8 pairs, batches of 2 from the port's `DataLoader`
    (shuffled, seeded from the training seed); records every loss."""

    losses: list[float]

    @tu.register_model()
    def model(self, config: tu.ModelConfig) -> fl.Chain:
        self.losses = []
        port_manual_seed(0)
        return fl.Chain(fl.Linear(10, 16), fl.SiLU(), fl.Linear(16, 10))

    @tu.register_callback()
    def checkpoint(self, config: tu.CheckpointConfig) -> tu.CheckpointCallback:
        return tu.CheckpointCallback(config)

    @tu.register_callback()
    def wandb(self, config: tu.WandbConfig) -> Any:
        return port_wandb.WandbCallback(config)

    @tu.register_callback()
    def neptune(self, config: tu.NeptuneConfig) -> Any:
        return port_neptune.NeptuneCallback(config)

    def create_data_iterable(self) -> tu.DataLoader[Any]:
        data = _mlp_data()
        config = tu.DataLoaderConfig(batch_size=2, shuffle=True)
        return tu.create_data_loader(data.__getitem__, len(data), config, collate_fn=_stack_pairs, seed=self.config.training.seed)

    def compute_loss(self, batch: tuple[torch.Tensor, torch.Tensor]) -> torch.Tensor:
        loss = torch.mean((self.model(batch[0]) - batch[1]) ** 2)
        self.losses.append(float(loss.detach()))
        return loss


def _port_config(optimizer: str = "SGD", lr: float = 0.1, **sections: dict[str, Any]) -> PortMlpConfig:
    config = PortMlpConfig.load_from_toml_string(MLP_TOML.format(optimizer=optimizer, lr=lr))
    for name, values in sections.items():
        setattr(config, name, getattr(tu, f"{name.capitalize()}Config")(**values))
    return config


# -- checkpoint and resume ------------------------------------------------------------


@pytest.mark.parametrize("optimizer", ["AdamW", "Lion8bit", "Prodigy"])
def test_checkpoint_resume_is_bit_equal_to_an_uninterrupted_run(tmp_path: Path, optimizer: str) -> None:
    """2 epochs of 4 steps (2 optimizer steps each, warmup 2 steps, shuffled
    batches) straight through, against 1 epoch, a checkpoint at its end, and
    a fresh trainer restored from it for the second: the same losses, the
    same weights, the same clock."""
    lr = 0.01 if optimizer != "Prodigy" else 1.0
    straight = PortMlpTrainer(_port_config(optimizer, lr, checkpoint={"directory": str(tmp_path / "a")}))
    straight.train()

    first_config = _port_config(optimizer, lr, checkpoint={"directory": str(tmp_path / "b"), "keep": 2})
    first_config.training.duration = tu.Epoch(1)
    first = PortMlpTrainer(first_config)
    first.train()
    assert sorted(p.name for p in (tmp_path / "b").iterdir()) == ["step_4"]
    meta = json.loads((tmp_path / "b" / "step_4" / "meta.json").read_text())
    assert meta == {"step": 4, "epoch": 1, "iteration": 2, "scheduler_steps": 2}

    resumed = PortMlpTrainer(_port_config(optimizer, lr, checkpoint={"directory": str(tmp_path / "b"), "keep": 2}))
    assert resumed.models["model"].optimizer is None
    resumed.checkpoint.restore(resumed, "step_4")
    assert resumed.models["model"].optimizer is not None  # built before its state was loaded
    resumed.train()

    assert first.losses + resumed.losses == straight.losses
    for key, value in straight.model.state_dict().items():
        assert torch.equal(resumed.model.state_dict()[key], value), key
    for attr in ("step", "epoch", "iteration"):
        assert getattr(resumed.clock, attr) == getattr(straight.clock, attr), attr
    assert resumed._scheduler_steps == straight._scheduler_steps == 4
    assert sorted(p.name for p in (tmp_path / "b").iterdir()) == ["step_4", "step_8"]


def test_checkpoint_meta_has_the_jax_keys(tmp_path: Path) -> None:
    class JaxConfig(jtu.BaseConfig):
        model: jtu.ModelConfig

    class JaxTrainer(jtu.Trainer[JaxConfig, Any]):
        @jtu.register_model()
        def model(self, config: jtu.ModelConfig) -> jfl.Chain:
            return jfl.Chain(jfl.Linear(4, 4))

        def create_data_iterable(self) -> list[Any]:
            return []

        def compute_loss(self, batch: Any) -> jax.Array:
            raise NotImplementedError

    toml = MLP_TOML.format(optimizer="SGD", lr=0.1).replace('device = "cpu"\n', "")
    jax_trainer = JaxTrainer(JaxConfig(**tomllib.loads(toml)))
    jax_callback = jax_checkpointing.CheckpointCallback(jax_checkpointing.CheckpointConfig(directory=str(tmp_path / "jax")))
    jax_meta = json.loads((jax_callback.save(jax_trainer, "t") / "meta.json").read_text())
    port_trainer = PortMlpTrainer(_port_config())
    port_callback = tu.CheckpointCallback(tu.CheckpointConfig(directory=str(tmp_path / "port")))
    port_meta = json.loads((port_callback.save(port_trainer, "t") / "meta.json").read_text())
    assert sorted(port_meta) == sorted(jax_meta)
    assert port_meta == jax_meta  # a fresh trainer: every counter 0 on both sides
    assert {f: getattr(tu.CheckpointConfig(), f) for f in ("directory", "interval", "keep")} == (
        jax_checkpointing.CheckpointConfig().model_dump()
    )


# -- ForceCommit ----------------------------------------------------------------------


def test_force_commit_on_a_clean_and_a_dirty_repository(tmp_path: Path) -> None:
    def git(*args: str) -> None:
        subprocess.run(["git", *args], cwd=tmp_path, check=True, capture_output=True)

    git("init", "-q")
    git("config", "user.email", "test@example.com")
    git("config", "user.name", "test")
    (tmp_path / "a.txt").write_text("a")
    git("add", "a.txt")
    git("commit", "-q", "-m", "first")
    port = tu.ForceCommit(tu.ForceCommitConfig(repo_path=str(tmp_path)))
    reference = jax_forcecommit.ForceCommit(jax_forcecommit.ForceCommitConfig(repo_path=str(tmp_path)))
    assert len(port.current_commit()) == 40 and port.current_commit() == reference.current_commit()
    port.on_train_begin(None)  # type: ignore[arg-type]
    reference.on_train_begin(None)  # type: ignore[arg-type]
    (tmp_path / "a.txt").write_text("b")
    for callback in (port, reference):
        with pytest.raises(RuntimeError, match="dirty"):
            callback.on_train_begin(None)  # type: ignore[arg-type]
    tu.ForceCommit(tu.ForceCommitConfig(force_commit=False, repo_path=str(tmp_path))).on_train_begin(None)  # type: ignore[arg-type]


# -- wandb and neptune through stubs --------------------------------------------------------


class _WandbRun:
    def __init__(self, calls: list[Any]) -> None:
        self.calls = calls

    def log(self, data: dict[str, Any], step: int | None = None) -> None:
        self.calls.append(("log", dict(data), step))

    def finish(self) -> None:
        self.calls.append(("finish",))


class _NeptuneSeries:
    def __init__(self, calls: list[Any], key: str) -> None:
        self.calls, self.key = calls, key

    def append(self, value: Any) -> None:
        self.calls.append(("append", self.key, value))


class _NeptuneRun:
    def __init__(self, calls: list[Any]) -> None:
        self.calls = calls

    def __getitem__(self, key: str) -> _NeptuneSeries:
        return _NeptuneSeries(self.calls, key)

    def stop(self) -> None:
        self.calls.append(("stop",))


def _stubs(calls: list[Any]) -> dict[str, types.ModuleType]:
    wandb, neptune = types.ModuleType("wandb"), types.ModuleType("neptune")

    def init(**kwargs: Any) -> _WandbRun:
        calls.append(("init", kwargs))
        return _WandbRun(calls)

    def init_run(**kwargs: Any) -> _NeptuneRun:
        calls.append(("init_run", kwargs))
        return _NeptuneRun(calls)

    wandb.init, neptune.init_run = init, init_run  # type: ignore[attr-defined]
    return {"wandb": wandb, "neptune": neptune}


class JaxMlpConfig(jtu.BaseConfig):
    model: jtu.ModelConfig
    wandb: jtu.WandbConfig
    neptune: jtu.NeptuneConfig


class JaxMlpTrainer(jtu.Trainer[JaxMlpConfig, Any], jtu.WandbMixin, jtu.NeptuneMixin):
    @jtu.register_model()
    def model(self, config: jtu.ModelConfig) -> jfl.Chain:
        return jfl.Chain(jfl.Linear(10, 16), jfl.SiLU(), jfl.Linear(16, 10))

    @jtu.register_callback()
    def wandb(self, config: jtu.WandbConfig) -> Any:
        return jax_wandb.WandbCallback(config)

    @jtu.register_callback()
    def neptune(self, config: jtu.NeptuneConfig) -> Any:
        return jax_neptune.NeptuneCallback(config)

    def create_data_iterable(self) -> list[tuple[jax.Array, jax.Array]]:
        data = _mlp_data()
        return [(jnp.asarray(np.stack([data[i][0], data[i + 1][0]])), jnp.asarray(np.stack([data[i][1], data[i + 1][1]])))
                for i in range(0, 8, 2)]  # fmt: skip

    def compute_loss(self, batch: tuple[jax.Array, jax.Array]) -> jax.Array:
        self.wandb_log({"custom": 1.0})
        self.neptune_log("custom", 1.0)
        return jnp.mean((self.model(batch[0]) - batch[1]) ** 2)


class PortLoggedTrainer(PortMlpTrainer):
    """The JAX trainer's data order (no shuffle) and its custom log calls."""

    def create_data_iterable(self) -> tu.DataLoader[Any]:
        data = _mlp_data()
        return tu.create_data_loader(data.__getitem__, 8, tu.DataLoaderConfig(batch_size=2, shuffle=False), collate_fn=_stack_pairs)

    def compute_loss(self, batch: tuple[torch.Tensor, torch.Tensor]) -> torch.Tensor:
        self.wandb_log({"custom": 1.0})
        self.neptune_log("custom", 1.0)
        return super().compute_loss(batch)


def _values(call: tuple[Any, ...]) -> list[float]:
    if call[0] == "log":
        return [float(v) for _, v in sorted(call[1].items())]
    return [float(call[2])] if call[0] == "append" else []


def _shape(call: tuple[Any, ...]) -> tuple[Any, ...]:
    """A call without its float values: the event, its keys and its step."""
    if call[0] == "log":
        return ("log", tuple(sorted(call[1])), call[2])
    if call[0] == "append":
        return ("append", call[1])
    return call


def test_wandb_and_neptune_log_the_jax_keys_at_the_jax_steps(monkeypatch: pytest.MonkeyPatch) -> None:
    logger_sections = {"wandb": {"mode": "offline", "project": "p", "tags": ["a"], "job_type": "extra"},
                       "neptune": {"project": "p", "name": "n", "tags": ["b"]}}  # fmt: skip
    toml = MLP_TOML.format(optimizer="SGD", lr=0.1).replace('device = "cpu"\n', "")
    jax_calls: list[Any] = []
    for name, module in _stubs(jax_calls).items():
        monkeypatch.setitem(sys.modules, name, module)
    jax_trainer = JaxMlpTrainer(JaxMlpConfig(**tomllib.loads(toml), **logger_sections))
    port_calls: list[Any] = []
    for name, module in _stubs(port_calls).items():
        monkeypatch.setitem(sys.modules, name, module)
    config = PortMlpConfig.load_from_toml_string(MLP_TOML.format(optimizer="SGD", lr=0.1))
    config.wandb = tu.WandbConfig.from_dict(logger_sections["wandb"])
    config.neptune = tu.NeptuneConfig.from_dict(logger_sections["neptune"])
    assert config.wandb.job_type == "extra"  # type: ignore[attr-defined]  # extra keys are kept, as pydantic's extra="allow"
    port_trainer = PortLoggedTrainer(config)
    load_jax_state_dict(port_trainer.model, {k: np.asarray(v) for k, v in jax_trainer.model.state_dict().items()})
    jax_trainer.train()
    port_trainer.train()

    assert [_shape(c) for c in port_calls] == [_shape(c) for c in jax_calls]
    assert port_calls[0] == jax_calls[0] and port_calls[1] == jax_calls[1]  # init and init_run, the same arguments
    assert sum(1 for c in port_calls if c[0] == "log" and "grad_norm" in c[1]) == 4
    for got, want in zip(port_calls, jax_calls):
        np.testing.assert_allclose(_values(got), _values(want), rtol=LOG_TOL, atol=1e-7)


def test_load_hf_dataset_through_a_stub(monkeypatch: pytest.MonkeyPatch) -> None:
    calls: list[Any] = []
    stub = types.ModuleType("datasets")
    stub.load_dataset = lambda path, **kwargs: calls.append((path, kwargs)) or ["item"]  # type: ignore[attr-defined]
    monkeypatch.setitem(sys.modules, "datasets", stub)
    assert port_hf.load_hf_dataset("/data/local", revision="r", split="test") == ["item"]
    assert jax_hf.load_hf_dataset("/data/local", revision="r", split="test") == ["item"]
    assert calls[0] == calls[1] == ("/data/local", {"revision": "r", "split": "test"})
    port_config = port_hf.HuggingfaceDatasetConfig(hf_repo="x")
    assert dict(port_config) == jax_hf.HuggingfaceDatasetConfig(hf_repo="x").model_dump()
    with pytest.raises(ValueError):
        port_hf.HuggingfaceDatasetConfig.from_dict({"hf_repo": "x", "bogus": 1})


def test_the_port_imports_no_logger_or_dataset_package() -> None:
    code = (
        "import sys, refiners_tpu_torch.training_utils, refiners_tpu_torch.training_utils.huggingface_datasets, "
        "refiners_tpu_torch.parallel; print(sorted(m for m in ('wandb', 'neptune', 'datasets', 'jax', 'optax') "
        "if m in sys.modules))"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, check=True)
    assert out.stdout.strip() == "[]"


# -- optimizers against optax ---------------------------------------------------------------

PARAM_SHAPES = {"w": (8, 5), "b": (5,), "k": (3, 4, 2)}


def _run_optimizers(jax_tx: Any, make_port: Any, steps: int = 5) -> None:
    rs = np.random.RandomState(0)
    init = {k: rs.randn(*s).astype(np.float32) for k, s in PARAM_SHAPES.items()}
    grads = [{k: rs.randn(*s).astype(np.float32) for k, s in PARAM_SHAPES.items()} for _ in range(steps)]
    jax_params = {k: jnp.asarray(v) for k, v in init.items()}
    state = jax_tx.init(jax_params)
    port_params = {k: torch.nn.Parameter(torch.tensor(v)) for k, v in init.items()}
    optimizer = make_port(list(port_params.values()))
    for g in grads:
        updates, state = jax_tx.update({k: jnp.asarray(v) for k, v in g.items()}, state, jax_params)
        jax_params = optax.apply_updates(jax_params, updates)
        for k, p in port_params.items():
            p.grad = torch.tensor(g[k])
        optimizer.step()
        for k, p in port_params.items():
            assert float(np.abs(p.detach().numpy() - np.asarray(jax_params[k])).max()) <= OPTIMIZER_TOL, k
    for k, p in port_params.items():
        assert not np.array_equal(p.detach().numpy(), init[k])


@pytest.mark.parametrize("name", ["AdamW8bit", "Lion8bit", "Prodigy"])
def test_optimizers_of_the_config_match_optax(name: str) -> None:
    """Each name of `Optimizers` that the port used to refuse, built by both
    configs with their shared defaults (betas (0.9, 0.999), weight decay
    1e-2); Prodigy at lr 1.0 (its scale), the others at 1e-2."""
    lr = 1.0 if name == "Prodigy" else 1e-2
    jax_tx = jtu.OptimizerConfig(optimizer=name, learning_rate=lr).get()
    port_config = tu.OptimizerConfig(optimizer=name, learning_rate=lr)
    expected = {"AdamW8bit": torch.optim.AdamW, "Lion8bit": tu.Lion, "Prodigy": tu.Prodigy}[name]
    _run_optimizers(jax_tx, lambda params: port_config.get(params))
    assert isinstance(port_config.get([torch.nn.Parameter(torch.zeros(1))]), expected)


@pytest.mark.parametrize(
    "case",
    ["lion", "lion_no_decay", "prodigy", "prodigy_safeguard"],
)
def test_lion_and_prodigy_defaults_match_optax(case: str) -> None:
    """The classes with optax's own defaults (Lion: b2 0.99, weight decay
    1e-3; Prodigy: no weight decay, no safeguard)."""
    if case == "lion":
        _run_optimizers(optax.lion(1e-2), lambda params: tu.Lion(params, lr=1e-2))
    elif case == "lion_no_decay":
        _run_optimizers(optax.lion(3e-3, b1=0.8, weight_decay=0.0), lambda p: tu.Lion(p, lr=3e-3, betas=(0.8, 0.99), weight_decay=0.0))
    elif case == "prodigy":
        _run_optimizers(optax.contrib.prodigy(), lambda params: tu.Prodigy(params))
    else:
        _run_optimizers(
            optax.contrib.prodigy(0.5, weight_decay=0.1, safeguard_warmup=True),
            lambda params: tu.Prodigy(params, lr=0.5, weight_decay=0.1, safeguard_warmup=True),
        )


def test_prodigy_takes_one_parameter_group_and_saves_its_estimate() -> None:
    a, b = torch.nn.Parameter(torch.ones(2)), torch.nn.Parameter(torch.ones(2))
    with pytest.raises(ValueError):
        tu.Prodigy([{"params": [a]}, {"params": [b]}])
    optimizer = tu.Prodigy([a, b])
    for _ in range(3):
        a.grad, b.grad = torch.tensor([1.0, -2.0]), torch.tensor([0.5, 0.5])
        optimizer.step()
    state = optimizer.state_dict()
    group = state["param_groups"][0]
    assert group["count"] == 3 and group["estim_lr"] >= 1e-6 and group["numerator_weighted"] > 0
    restored = tu.Prodigy([torch.nn.Parameter(a.detach().clone()), torch.nn.Parameter(b.detach().clone())])
    restored.load_state_dict(state)
    assert restored.param_groups[0]["estim_lr"] == optimizer.param_groups[0]["estim_lr"]


# -- remat ------------------------------------------------------------------------------


# one class name on both sides, so that the state-dict keys match
JaxBlock = type("Block", (jfl.Chain,), {})
PortBlock = type("Block", (fl.Chain,), {})


def _port_remat_model() -> fl.Chain:
    return fl.Chain(
        fl.Linear(16, 32),
        PortBlock(
            fl.Linear(32, 32),
            fl.SiLU(),
            fl.Residual(fl.Parallel(fl.Identity(), fl.UseContext("cond", "emb")), fl.Lambda(lambda a, b: a + b)),
        ),
        PortBlock(fl.Linear(32, 32), fl.GeLU()),
        fl.Linear(32, 4),
    )


def _remat_models() -> tuple[jfl.Chain, fl.Chain]:
    """The model of tests/parallel/test_remat.py on both sides, one set of
    weights: two blocks, the first reading a context."""
    jax_manual_seed(0)
    jax_model = jfl.Chain(
        jfl.Linear(16, 32),
        JaxBlock(
            jfl.Linear(32, 32),
            jfl.SiLU(),
            jfl.Residual(jfl.Parallel(jfl.Identity(), jfl.UseContext("cond", "emb")), jfl.Lambda(lambda a, b: a + b)),
        ),
        JaxBlock(jfl.Linear(32, 32), jfl.GeLU()),
        jfl.Linear(32, 4),
    )
    port_model = _port_remat_model()
    load_jax_state_dict(port_model, {k: np.asarray(v) for k, v in jax_model.state_dict().items()})
    return jax_model, port_model


def _port_loss_and_grads(model: fl.Chain, x: np.ndarray, emb: np.ndarray, later: np.ndarray | None = None) -> tuple[float, dict[str, np.ndarray]]:
    """sum(model(x)²) with the "cond" context at `emb`; with `later`, the
    context is set to it between the forward and the backward."""
    model.zero_grad(set_to_none=True)
    model.set_context("cond", {"emb": torch.tensor(emb)})
    loss = torch.sum(model(torch.tensor(x)) ** 2)
    if later is not None:
        model.set_context("cond", {"emb": torch.tensor(later)})
    loss.backward()
    return float(loss.detach()), {name: p.grad.numpy().copy() for name, p in model.named_parameters()}  # type: ignore[union-attr]


def test_remat_matches_jax_and_is_reversible() -> None:
    jax_model, port_model = _remat_models()
    rs = np.random.RandomState(0)
    x, emb = rs.randn(2, 16).astype(np.float32), rs.randn(2, 32).astype(np.float32)

    def jax_loss(m: Any, v: jax.Array, e: jax.Array) -> jax.Array:
        m.set_context("cond", {"emb": e})
        return jnp.sum(m(v) ** 2)

    base_loss, base_grads = _port_loss_and_grads(port_model, x, emb)
    assert jax_remat.apply_remat(jax_model, JaxBlock) == 2
    assert apply_remat(port_model, PortBlock) == 2
    assert sum(1 for _ in port_model.walk(Recompute, recurse=True)) == 2
    assert all(isinstance(block.parent, Recompute) for block in port_model.layers(PortBlock, recurse=True))
    jax_value, jax_grads = jax.value_and_grad(jax_loss)(jax_model, jnp.asarray(x), jnp.asarray(emb))
    remat_loss, remat_grads = _port_loss_and_grads(port_model, x, emb)
    # JAX's gradients in the port's layout, under the same (wrapped) keys
    grads_in_port_layout = _port_remat_model()
    apply_remat(grads_in_port_layout, PortBlock)
    load_jax_state_dict(grads_in_port_layout, {k: np.asarray(v) for k, v in jax_grads.state_dict().items()})
    want = {name: p.detach().numpy() for name, p in grads_in_port_layout.named_parameters()}
    assert list(want) == list(remat_grads) and any("Recompute" in name for name in want)
    assert remat_loss == pytest.approx(base_loss, rel=REMAT_TOL)
    assert remat_loss == pytest.approx(float(jax_value), rel=REMAT_TOL)
    assert len(remat_grads) == len(base_grads) == 8
    for (name, got), base in zip(remat_grads.items(), base_grads.values()):
        assert _rel(got, base) <= REMAT_TOL, name
        assert _rel(got, want[name]) <= REMAT_TOL, name

    assert remove_remat(port_model) == 2
    assert jax_remat.remove_remat(jax_model) == 2
    assert sum(1 for _ in port_model.walk(Recompute, recurse=True)) == 0
    assert all(type(block.parent) is fl.Chain for block in port_model.layers(PortBlock, recurse=True))
    assert list(port_model.state_dict()) == list(_port_remat_model().state_dict())
    after_loss, after_grads = _port_loss_and_grads(port_model, x, emb)
    assert after_loss == pytest.approx(base_loss, rel=REMAT_TOL)
    for name, got in after_grads.items():
        assert _rel(got, base_grads[name]) <= REMAT_TOL, name


def test_remat_recomputes_with_the_contexts_of_the_forward() -> None:
    """The context changes between the forward and the backward: the
    gradient is the one of the forward's context (JAX's meaning), where a
    bare torch checkpoint would recompute with the new value. The block adds
    the context before its Linear, so the Linear's weight gradient reads it."""
    port_manual_seed(0)
    model = fl.Chain(
        fl.Linear(16, 32),
        PortBlock(fl.Sum(fl.Identity(), fl.UseContext("cond", "emb")), fl.Linear(32, 32), fl.SiLU()),
        fl.Linear(32, 4),
    )
    rs = np.random.RandomState(1)
    x, emb, later = (rs.randn(*s).astype(np.float32) for s in ((2, 16), (2, 32), (2, 32)))
    base_loss, base_grads = _port_loss_and_grads(model, x, emb)
    apply_remat(model, PortBlock)
    loss, grads = _port_loss_and_grads(model, x, emb, later=later)
    assert loss == base_loss
    for (name, got), base in zip(grads.items(), base_grads.values()):
        assert _rel(got, base) <= REMAT_TOL, name
    assert np.array_equal(model.use_context("cond")["emb"].numpy(), later)  # the current value put back

    # the hazard it guards against: a bare checkpoint reads the context at backward time
    remove_remat(model)
    block = next(model.layers(PortBlock, recurse=True))
    forward = block.forward
    block.forward = lambda *a: torch.utils.checkpoint.checkpoint(forward, *a, use_reentrant=False)  # type: ignore[method-assign]
    with torch.utils.checkpoint.set_checkpoint_early_stop(False):
        _, bare = _port_loss_and_grads(model, x, emb, later=later)
    assert max(_rel(bare[name], base_grads[name]) for name in bare) > 1e-3


# -- one decoder step of the full-width SD1.5 VAE through both Trainers ------------------------

VAE_TOML = """
[clock]
verbose = false

[training]
duration = "1:step"
seed = 0

[optimizer]
optimizer = "AdamW"
learning_rate = 1e-3

[lr_scheduler]
type = "ConstantLR"

[encoder]
requires_grad = false

[decoder]
requires_grad = true
"""
VAE_IMAGE = np.random.RandomState(3).uniform(-1, 1, size=(1, 32, 32, 3)).astype(np.float32)  # NHWC


class JaxVaeConfig(jtu.BaseConfig):
    encoder: jtu.ModelConfig
    decoder: jtu.ModelConfig


class JaxVaeTrainer(jtu.Trainer[JaxVaeConfig, Any]):
    """sd-vae-ft-mse's objective: the decoder trained on the MSE of its
    reconstruction, the encoder frozen."""

    @jtu.register_model()
    def encoder(self, config: jtu.ModelConfig) -> JaxEncoder:
        jax_manual_seed(0)
        return JaxEncoder()

    @jtu.register_model()
    def decoder(self, config: jtu.ModelConfig) -> JaxDecoder:
        return JaxDecoder()

    def create_data_iterable(self) -> Any:
        return jtu.create_data_loader(lambda i: jnp.asarray(VAE_IMAGE), 1, jtu.DataLoaderConfig(shuffle=False))

    def compute_loss(self, batch: jax.Array) -> jax.Array:
        return jnp.mean((self.decoder(self.encoder(batch)) - batch) ** 2)


class PortVaeConfig(tu.BaseConfig):
    encoder: tu.ModelConfig
    decoder: tu.ModelConfig
    recorder: tu.CallbackConfig = tu.CallbackConfig()


class _GradRecorder(tu.Callback[Any]):
    def on_optimizer_step_begin(self, trainer: Any) -> None:
        trainer.grads = {k: p.grad.clone() for k, p in trainer.decoder.named_parameters()}


class PortVaeTrainer(tu.Trainer[PortVaeConfig, torch.Tensor]):
    @tu.register_callback()
    def recorder(self, config: tu.CallbackConfig) -> _GradRecorder:
        return _GradRecorder()

    @tu.register_model()
    def encoder(self, config: tu.ModelConfig) -> Encoder:
        return Encoder()

    @tu.register_model()
    def decoder(self, config: tu.ModelConfig) -> Decoder:
        return Decoder()

    def create_data_iterable(self) -> tu.DataLoader[torch.Tensor]:
        image = torch.tensor(nhwc_to_nchw(VAE_IMAGE))
        return tu.create_data_loader(lambda i: image, 1, tu.DataLoaderConfig(shuffle=False))

    def compute_loss(self, batch: torch.Tensor) -> torch.Tensor:
        with torch.no_grad():
            latents = self.encoder(batch)
        return torch.mean((self.decoder(latents) - batch) ** 2)


def test_vae_decoder_training_step_matches_the_jax_trainer() -> None:
    jax_config = tomllib.loads(VAE_TOML)
    jax_config["training"]["jit_step"] = True  # one XLA program: faster on the CPU than op by op
    jax_trainer = JaxVaeTrainer(JaxVaeConfig(**jax_config))
    port_config = PortVaeConfig.load_from_toml_string(VAE_TOML)
    port_config.training.device = "cpu"
    port_trainer = PortVaeTrainer(port_config)
    for name in ("encoder", "decoder"):
        load_jax_state_dict(getattr(port_trainer, name), {k: np.asarray(v) for k, v in getattr(jax_trainer, name).state_dict().items()})
    assert port_trainer.learnable_parameter_count == sum(p.numel() for p in port_trainer.decoder.parameters()) > 49_000_000
    mid_attention = port_trainer.decoder.layer((2, 0, 1, 1), fl.SelfAttention2d)
    assert (mid_attention.num_heads, mid_attention.channels) == (1, 512)
    before = {k: v.clone() for k, v in port_trainer.decoder.state_dict().items()}
    encoder_before = {k: v.clone() for k, v in port_trainer.encoder.state_dict().items()}
    jax_trainer.train()
    port_trainer.train()

    assert float(port_trainer.loss.detach()) == pytest.approx(float(jax_trainer.loss), rel=VAE_LOSS_TOL)  # type: ignore[arg-type]
    want_grads = Decoder()
    load_jax_state_dict(want_grads, {k: np.asarray(v) for k, v in jax_trainer._last_grads["decoder"].state_dict().items()})
    want_grads = dict(want_grads.named_parameters())
    floor = 1e-3 * float(np.sqrt(sum(float((w.detach() ** 2).sum()) for w in want_grads.values())))
    for key, grad in port_trainer.grads.items():
        w = want_grads[key].detach().numpy()
        assert float(np.linalg.norm(grad.numpy() - w)) <= VAE_GRAD_TOL * max(float(np.linalg.norm(w)), floor), key
    want = Decoder()
    load_jax_state_dict(want, {k: np.asarray(v) for k, v in jax_trainer.decoder.state_dict().items()})
    want_weights = want.state_dict()
    got = port_trainer.decoder.state_dict()

    def flat(weights: dict[str, torch.Tensor]) -> np.ndarray:
        return torch.cat([weights[k].flatten() for k in sorted(weights)]).numpy()

    assert _rel(flat(got), flat(want_weights)) <= VAE_WEIGHT_TOL
    lr = port_config.optimizer.learning_rate
    assert all(float((got[k] - v).abs().max()) <= 2 * lr for k, v in want_weights.items())
    assert all(not torch.equal(got[k], v) for k, v in before.items() if v.ndim >= 2)
    assert all(torch.equal(port_trainer.encoder.state_dict()[k], v) for k, v in encoder_before.items())
