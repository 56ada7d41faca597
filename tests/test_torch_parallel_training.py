"""Training over the port's mesh, on the CPU.

Counterparts of ``tests/parallel/test_sharding.py``'s data-parallel gradient
and ``tests/training_utils/test_trainer_mesh.py``: one gloo group of 4 CPU
ranks (``torch_mesh_group.py``) takes the gradients of the JAX sharding
test's toy transformer (bridged weights) on a data-parallel and a DP×TP
mesh, trains under ``[training.mesh]`` (DP, then DP×TP, with active
clipping and gradient accumulation; at DP×TP with AdamW, Lion and Prodigy
too), and saves and restores checkpoints there. Here meanwhile: the JAX
gradients, the JAX Trainer under its own ``[training.mesh]`` (data 4 ×
tensor 2 on the 8 virtual devices) from the same weights, and after it the
unmeshed port Trainer with each optimizer.
"""

from __future__ import annotations

from pathlib import Path
from typing import Any

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import refiners_tpu.fluxion.layers as jfl
import refiners_tpu.training_utils as jtu
from refiners_tpu.fluxion import manual_seed
from torch_mesh_group import OPTIMIZER_CASE, mock_batches, mock_trainer, start_group

MOCK_TOML = Path(__file__).parent / "training_utils" / "mock_config.toml"
OPTIMIZERS = ["AdamW", "Lion8bit", "Prodigy"]

# float32 on both sides; a mesh changes the summation order only
GRAD_TOL = 1e-5  # abs, as the JAX test holds its data-parallel gradient
TRAINER_TOL = 1e-5  # rel, as test_torch_training.py holds the Trainer against JAX's


def _jax_toy_transformer() -> jfl.Chain:
    from refiners_tpu.foundationals.clip.common import FeedForward

    manual_seed(0)
    return jfl.Chain(
        jfl.Residual(jfl.LayerNorm(64), jfl.SelfAttention(embedding_dim=64, num_heads=4)),
        jfl.Residual(jfl.LayerNorm(64), FeedForward(embedding_dim=64, feedforward_dim=128)),
    )


def _transposed(path: str, g: np.ndarray) -> np.ndarray:
    """A port gradient in the JAX layout: Linear weights (out, in) → (in, out)."""
    return g.T if path.endswith(".weight") and g.ndim == 2 else g


class _JaxMockConfig(jtu.BaseConfig):
    mock_model: jtu.ModelConfig
    mock_model_frozen: jtu.ModelConfig
    recorder: jtu.CallbackConfig = jtu.CallbackConfig()


class _JaxRecorder(jtu.Callback[Any]):
    """`torch_mesh_group.Recorder`'s JAX side (weights in the JAX layout)."""

    def __init__(self) -> None:
        self.records: list[dict[str, Any]] = []

    def on_optimizer_step_end(self, trainer: Any) -> None:
        self.records.append({
            "loss": float(trainer.loss), "grad_norm": float(trainer.grad_norm),
            "lr": trainer.current_learning_rate("mock_model"),
            "weights": {k: np.asarray(v) for k, v in trainer.mock_model.state_dict().items()},
        })  # fmt: skip


class _JaxMockTrainer(jtu.Trainer[_JaxMockConfig, Any]):
    """`torch_mesh_group.MockTrainer` in the JAX package."""

    @jtu.register_model()
    def mock_model(self, config: jtu.ModelConfig) -> jfl.Chain:
        manual_seed(0)
        return jfl.Chain(jfl.Linear(16, 32), jfl.SelfAttention(embedding_dim=32, num_heads=4), jfl.Linear(32, 16))

    @jtu.register_model()
    def mock_model_frozen(self, config: jtu.ModelConfig) -> jfl.Chain:
        return jfl.Chain(jfl.Linear(16, 16))

    @jtu.register_callback()
    def recorder(self, config: jtu.CallbackConfig) -> _JaxRecorder:
        return _JaxRecorder()

    def create_data_iterable(self) -> list[dict[str, jax.Array]]:
        return [{k: jnp.asarray(v.numpy()) for k, v in batch.items()} for batch in mock_batches()]

    def compute_loss(self, batch: dict[str, jax.Array]) -> jax.Array:
        return jnp.mean((self.mock_model(batch["inputs"]) - batch["targets"]) ** 2)


def _jax_mesh_trainer() -> _JaxMockTrainer:
    """`mock_trainer`'s configuration in the JAX package, under its
    ``[training.mesh]`` at data 4 × tensor 2."""
    import tomllib

    raw = tomllib.loads(MOCK_TOML.read_text())
    raw["training"].update(
        device="cpu", duration="2:iteration", gradient_clipping_max_norm=0.02, mesh={"data": 4, "tensor": 2}
    )
    raw["lr_scheduler"]["warmup"] = "0:iteration"
    return _JaxMockTrainer(_JaxMockConfig(**raw))


@pytest.fixture(scope="module")
def group(tmp_path_factory: pytest.TempPathFactory) -> tuple[dict[str, Any], dict[str, Any]]:
    """(rank 0's results of every port case, the JAX side's and the unmeshed port Trainer's)."""
    directory: Path = tmp_path_factory.mktemp("mesh_training")
    model = _jax_toy_transformer()
    x = np.random.RandomState(1).randn(8, 6, 64).astype(np.float32)
    np.savez(directory / "toy.npz", **{k: np.asarray(v) for k, v in model.state_dict().items()})
    np.savez(directory / "inputs.npz", toy_x=x)
    jax_trainer = _jax_mesh_trainer()
    weights = {k: np.asarray(v) for k, v in jax_trainer.mock_model.state_dict().items()}
    np.savez(directory / "mock.npz", **weights)
    ranks = start_group(directory, "torch_mesh_group:training_cases")

    grads = jax.grad(lambda m, v: jnp.mean(m(v) ** 2))(model, jnp.asarray(x))
    jax_trainer.train()
    local = {"grads": {k: np.asarray(v) for k, v in grads.state_dict().items()},
             "jax_mesh": jax_trainer.recorder.records, "jax_mesh_shape": dict(jax_trainer.mesh.shape)}  # fmt: skip
    for optimizer in ("SGD", *OPTIMIZERS):
        single = mock_trainer(None, weights) if optimizer == "SGD" else mock_trainer(None, None, optimizer, *OPTIMIZER_CASE)
        single.train()
        local[optimizer] = single.recorder.records
    return ranks.results(), local


def _case(group: tuple[dict[str, Any], dict[str, Any]], name: str) -> Any:
    result = group[0][name]
    if isinstance(result, dict) and "error" in result:
        pytest.fail(f"case {name!r} raised on the ranks:\n{result['error']}")
    return result


@pytest.mark.parametrize("mesh", ["4x1", "2x2"])
def test_mesh_gradients_match_jax_single_device(group: tuple[dict[str, Any], dict[str, Any]], mesh: str) -> None:
    """Each rank's rows of a batch of 8, the loss of its rows, its gradients
    averaged over "data" (the Trainer's rule): every gradient, the split ones
    gathered, equals JAX's on the whole batch on one device."""
    got = _case(group, f"grads {mesh}")
    want = group[1]["grads"]
    assert sorted(got["grads"]) == sorted(want)
    for path, g in got["grads"].items():
        np.testing.assert_allclose(_transposed(path, g), want[path], atol=GRAD_TOL, err_msg=path)
    split = {place for place, _ in got["layout"].values()} - {"replicated"}
    assert split == ({"Shard(0)", "Shard(1)", "Replicate"} if mesh == "2x2" else set())


@pytest.mark.parametrize("mesh", ["4x1", "2x2"])
def test_trainer_under_training_mesh_matches_the_unmeshed_trainer(
    group: tuple[dict[str, Any], dict[str, Any]], mesh: str
) -> None:
    """Two optimizer steps (8 batches, accumulation 4, clipping active) under
    ``[training.mesh]`` data = 4, then data = 2 × tensor = 2: at each step
    the loss (the mean over "data": the whole batch's), the grad norm (over
    the split gradients' shards too), the learning rate and every weight
    equal the unmeshed port Trainer's on the same batches."""
    got = _case(group, f"trainer {mesh}")
    want = group[1]["SGD"]
    assert got["mesh"] == tuple(int(n) for n in mesh.split("x"))
    assert len(got["records"]) == len(want) == 2 and got["steps"] == 8
    _assert_records(got["records"], want)
    assert all(single["grad_norm"] > 0.02 for single in want)  # the clipping acted
    placements = {place for place, _ in got["layout"].values()}
    assert placements == ({"replicated", "Shard(0)", "Shard(1)", "Replicate"} if mesh == "2x2" else {"replicated"})


def _assert_records(got: list[dict[str, Any]], want: list[dict[str, Any]], jax_side: bool = False) -> None:
    """Each optimizer step's learning rate (the same float in both ports'
    runs), loss, grad norm and weights; against the JAX side (`jax_side`)
    the port's (out, in) Linear weights transposed to its (in, out)."""
    assert len(got) == len(want)
    for record, other in zip(got, want):
        if jax_side:
            assert record["lr"] == pytest.approx(other["lr"], rel=TRAINER_TOL, abs=1e-12)
        else:
            assert record["lr"] == other["lr"]
        assert record["loss"] == pytest.approx(other["loss"], rel=TRAINER_TOL)
        assert record["grad_norm"] == pytest.approx(other["grad_norm"], rel=TRAINER_TOL)
        assert sorted(record["weights"]) == sorted(other["weights"])
        for key, weight in other["weights"].items():
            mine = _transposed(key, record["weights"][key]) if jax_side else record["weights"][key]
            np.testing.assert_allclose(mine, weight, rtol=TRAINER_TOL, atol=1e-7, err_msg=key)


@pytest.mark.parametrize("mesh", ["4x1", "2x2"])
def test_trainer_under_training_mesh_matches_the_jax_mesh_trainer(
    group: tuple[dict[str, Any], dict[str, Any]], mesh: str
) -> None:
    """The same two optimizer steps against the JAX Trainer under its own
    ``[training.mesh]`` (data 4 × tensor 2 over 8 virtual devices, GSPMD),
    from the same weights over the same batches: at each step the loss, the
    grad norm, the learning rate and every weight."""
    assert group[1]["jax_mesh_shape"] == {"data": 4, "tensor": 2}
    _assert_records(_case(group, f"trainer {mesh}")["records"], group[1]["jax_mesh"], jax_side=True)


@pytest.mark.parametrize("optimizer", OPTIMIZERS)
def test_optimizers_step_split_and_whole_parameters_alike(
    group: tuple[dict[str, Any], dict[str, Any]], optimizer: str
) -> None:
    """AdamW, Lion and Prodigy under ``[training.mesh]`` data 2 × tensor 2
    (two optimizer steps, clipping active; float64 and no projection biases
    in the attention, `OPTIMIZER_CASE`), stepping the split
    (`DTensor`) and the whole parameters of one model: every record equals
    the unmeshed Trainer's with the same optimizer. Prodigy's estimate sums
    over every shard. AdamW's split parameters have a parameter group of
    their own (torch's multi-tensor step takes one tensor type a list)."""
    got = _case(group, f"trainer 2x2 {optimizer}")
    _assert_records(got["records"], group[1][optimizer])
    assert got["groups"] == ([{False}, {True}] if optimizer == "AdamW" else [{False, True}])


@pytest.mark.parametrize("mesh", ["4x1", "2x2"])
def test_mesh_checkpoint_roundtrip(group: tuple[dict[str, Any], dict[str, Any]], mesh: str) -> None:
    """Counterpart of the JAX package's test of the same name: the AdamW
    Trainer under ``[training.mesh]`` saved (every rank calls `save`; rank 0
    writes whole tensors, the pruning runs once) and restored into a fresh
    meshed Trainer: every weight, split ones as their shards again, and the
    optimizer state equal, the clock the trained one's."""
    got = _case(group, f"checkpoint {mesh}")
    assert got["tags"] == ["final"]
    assert got["saved_types"] == ["Tensor"]
    assert got["saved_shapes"] == {k: v.shape for k, v in got["trained"].items()}
    for key, weight in got["trained"].items():
        np.testing.assert_array_equal(got["restored"][key], weight, err_msg=key)
    for name, state in got["trained_state"].items():
        assert sorted(state) == sorted(got["restored_state"][name])
        for k, v in state.items():
            np.testing.assert_array_equal(np.asarray(got["restored_state"][name][k]), np.asarray(v), err_msg=f"{name}.{k}")
    placements = {place for place, _ in got["restored_layout"].values()}
    assert placements == ({"replicated", "Shard(0)", "Shard(1)", "Replicate"} if mesh == "2x2" else {"replicated"})
    assert got["steps"] == (8, 8)


@pytest.mark.parametrize("meshes", ["2x2 to 4x1", "2x2 to 2x2", "4x1 to 2x2"])
def test_optimizer_state_restores_at_another_tensor_size(group: tuple[dict[str, Any], dict[str, Any]], meshes: str) -> None:
    """AdamW (float64, no projection biases: `OPTIMIZER_CASE`) saved after 2
    optimizer steps at one mesh and restored into a fresh Trainer at
    another: the file keys the optimizer's state by parameter name (at
    tensor 2 AdamW has two parameter groups, at tensor 1 one), and the 2
    steps after the restore equal steps 3 and 4 of the run straight
    through at the restoring mesh."""
    got = _case(group, f"resume {meshes}")
    saved_at, restored_at = meshes.split(" to ")
    assert len(got["groups"]) == (2 if restored_at == "2x2" else 1) and sum(got["groups"]) == 9
    assert len(got["saved_groups"]) == (2 if saved_at == "2x2" else 1)
    assert got["saved_state"] == sorted(name for names in got["saved_groups"] for name in names)
    assert len(got["saved_state"]) == 9 and all(isinstance(name, str) for name in got["saved_state"])
    assert len(got["straight"]) == 4 and got["steps"] == 16
    _assert_records(got["records"], got["straight"][2:])


def test_loggers_start_one_run_for_the_ranks(group: tuple[dict[str, Any], dict[str, Any]]) -> None:
    """Every rank builds the wandb and neptune callbacks (stub modules): the
    first rank of the process group alone starts a run of each."""
    assert _case(group, "loggers")["runs_by_rank"] == [2, 0, 0, 0]


def test_multi_tensor_optimizers_take_split_parameters_in_a_group_of_their_own(
    group: tuple[dict[str, Any], dict[str, Any]],
) -> None:
    """torch's multi-tensor AdamW step (its default for CUDA tensors) over a
    model at data 2 × tensor 2 raises on a list that mixes `DTensor` and
    plain parameters; over the groups `OptimizerConfig.get` makes (split
    parameters apart) it steps."""
    got = _case(group, "foreach")
    assert "mixed torch.Tensor and DTensor" in got["as given"]
    assert got["by type"] == "stepped"
