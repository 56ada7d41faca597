"""The port's SD1.5 training slice against the JAX package, on the CPU.

- the routing rule of the attention layers (every kernel dtype, float32
  included, on the card from seq 1024);
- `SD1UNet` at base_channels=32 on bridged weights: forward, and the loss
  and every parameter gradient of the DDPM noise-regression objective;
- `DDPM`'s timesteps and `add_noise`;
- the Trainer on `tests/training_utils/mock_config.toml`, step by step
  against the JAX Trainer: learning rates, grad norms, weights, the clock
  and the callback event order;
- the TOML config (dataclasses, no pydantic) and the training example;
- that the port imports none of jax, pydantic, optax and safetensors.
"""

import subprocess
import sys
from pathlib import Path
from typing import Any

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import refiners_tpu.fluxion.layers as jfl
import refiners_tpu.training_utils as jtu
import refiners_tpu_torch.fluxion.layers as fl
import refiners_tpu_torch.training_utils as tu
from refiners_tpu.foundationals.latent_diffusion import DDPM as JaxDDPM
from refiners_tpu.foundationals.latent_diffusion import SD1UNet as JaxSD1UNet
from refiners_tpu_torch.conversion import load_jax_state_dict, nchw_to_nhwc, nhwc_to_nchw
from refiners_tpu_torch.foundationals.latent_diffusion import DDPM, SD1UNet
from refiners_tpu_torch.ops.attention import flash_auto

REPO = Path(__file__).resolve().parents[1]
MOCK_TOML = REPO / "tests" / "training_utils" / "mock_config.toml"
# float32 on both sides; a deep UNet amplifies summation-order noise
UNET_TOL = 1e-4
# a few optimizer steps of a 3-layer MLP, float32 on both sides
TRAINER_TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _torch_threads() -> Any:
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _rel(got: np.ndarray, want: np.ndarray) -> float:
    return float(np.linalg.norm(np.asarray(got) - np.asarray(want)) / np.linalg.norm(np.asarray(want)))


# -- routing -----------------------------------------------------------------


class _Standin:
    """What `flash_auto` reads of a tensor: its device kind and dtype."""

    def __init__(self, dtype: torch.dtype, is_cuda: bool = True) -> None:
        self.dtype, self.is_cuda = dtype, is_cuda


@pytest.mark.parametrize(
    "dtype,seq,expected",
    [
        (torch.float32, 4096, True),
        (torch.bfloat16, 4096, True),
        (torch.float16, 1024, True),
        (torch.bfloat16, 1023, False),
        (torch.float32, 1023, False),
    ],
)
def test_flash_auto_routes_by_dtype_before_any_launch(dtype: torch.dtype, seq: int, expected: bool) -> None:
    """On the card every kernel dtype, float32 included, takes the kernel
    from seq 1024 on; the CPU never does."""
    x: Any = _Standin(dtype)
    assert flash_auto(x, seq, seq) is expected
    assert flash_auto(x, seq, 77) is False
    assert flash_auto(_Standin(dtype, is_cuda=False), seq, seq) is False  # type: ignore[arg-type]


# -- SD1UNet and DDPM ----------------------------------------------------------


@pytest.fixture(scope="module")
def unets() -> tuple[Any, SD1UNet]:
    jax_unet = JaxSD1UNet(in_channels=4, base_channels=32)
    port_unet = SD1UNet(in_channels=4, base_channels=32)
    load_jax_state_dict(port_unet, {k: np.asarray(v) for k, v in jax_unet.state_dict().items()})
    return jax_unet, port_unet


@pytest.fixture(scope="module")
def batch() -> dict[str, Any]:
    rs = np.random.RandomState(0)
    return {
        "x": rs.randn(2, 16, 16, 4).astype(np.float32),  # NHWC, as the JAX package takes it
        "noise": rs.randn(2, 16, 16, 4).astype(np.float32),
        "text": rs.randn(2, 77, 768).astype(np.float32),
        "steps": [100, 700],
    }


def _jax_loss(unet: Any, solver: Any, batch: dict[str, Any], x: jax.Array) -> jax.Array:
    noise = jnp.asarray(batch["noise"])
    noised = solver.add_noise(x, noise, batch["steps"])
    unet.set_timestep(solver.timesteps[jnp.asarray(batch["steps"])])
    unet.set_clip_text_embedding(jnp.asarray(batch["text"]))
    return jnp.mean((unet(noised) - noise) ** 2)


def _port_loss(unet: SD1UNet, solver: DDPM, batch: dict[str, Any]) -> torch.Tensor:
    noise = torch.tensor(nhwc_to_nchw(batch["noise"]))
    noised = solver.add_noise(torch.tensor(nhwc_to_nchw(batch["x"])), noise, batch["steps"])
    unet.set_timestep(solver.timesteps[batch["steps"]])
    unet.set_clip_text_embedding(torch.tensor(batch["text"]))
    return torch.mean((unet(noised) - noise) ** 2)


def test_sd1_unet_forward_matches_jax(unets: tuple[Any, SD1UNet], batch: dict[str, Any]) -> None:
    jax_unet, port_unet = unets

    def forward(unet: Any, x: jax.Array, text: jax.Array, timestep: jax.Array) -> jax.Array:
        unet.set_timestep(timestep)
        unet.set_clip_text_embedding(text)
        return unet(x)

    timestep = np.array([899, 299], dtype=np.int32)
    want = jax.jit(forward)(jax_unet, jnp.asarray(batch["x"]), jnp.asarray(batch["text"]), jnp.asarray(timestep))
    port_unet.set_timestep(torch.tensor(timestep))
    port_unet.set_clip_text_embedding(torch.tensor(batch["text"]))
    with torch.no_grad():
        got = port_unet(torch.tensor(nhwc_to_nchw(batch["x"])))
    assert got.shape == (2, 4, 16, 16)
    assert _rel(nchw_to_nhwc(got.numpy()), np.asarray(want)) <= UNET_TOL


def test_sd1_unet_loss_and_gradients_match_jax(unets: tuple[Any, SD1UNet], batch: dict[str, Any]) -> None:
    """mean((unet(add_noise(x, n, t)) − n)²): the loss, and the gradient of
    every parameter, on the plain paths (float32, CPU)."""
    jax_unet, port_unet = unets
    jax_solver, port_solver = JaxDDPM(num_inference_steps=1000), DDPM(num_inference_steps=1000)
    loss_and_grad = jax.jit(jax.value_and_grad(lambda u, x: _jax_loss(u, jax_solver, batch, x)))
    want_loss, want_grads = loss_and_grad(jax_unet, jnp.asarray(batch["x"]))
    grads_in_port_layout = SD1UNet(in_channels=4, base_channels=32)
    load_jax_state_dict(grads_in_port_layout, {k: np.asarray(v) for k, v in want_grads.state_dict().items()})
    want = dict(grads_in_port_layout.named_parameters())

    port_unet.zero_grad(set_to_none=True)
    loss = _port_loss(port_unet, port_solver, batch)
    loss.backward()
    assert abs(float(loss.detach()) - float(want_loss)) <= UNET_TOL * abs(float(want_loss))
    named = list(port_unet.named_parameters())
    assert len(named) == len(want) and len(named) > 300
    # At base_channels=32 the GroupNorms have one channel per group, so the
    # bias of a conv that feeds one has an exact zero gradient (both sides
    # give ~1e-8 of noise): each gradient is held relative to its own norm,
    # floored at 1e-3 of the global gradient norm.
    floor = 1e-3 * float(np.sqrt(sum(float((w.detach() ** 2).sum()) for w in want.values())))
    for name, p in named:
        assert p.grad is not None, name
        w = want[name].detach().numpy()
        err = float(np.linalg.norm(p.grad.numpy() - w))
        assert err <= UNET_TOL * max(float(np.linalg.norm(w)), floor), name


def test_ddpm_timesteps_and_add_noise_match_jax() -> None:
    jax_solver, port_solver = JaxDDPM(num_inference_steps=1000), DDPM(num_inference_steps=1000)
    np.testing.assert_array_equal(port_solver.timesteps.numpy(), np.asarray(jax_solver.timesteps))
    for name in ("cumulative_scale_factors", "noise_std"):
        np.testing.assert_array_equal(getattr(port_solver, name).numpy(), np.asarray(getattr(jax_solver, name)))
    rs = np.random.RandomState(5)
    x, noise = rs.randn(3, 8, 8, 4).astype(np.float32), rs.randn(3, 8, 8, 4).astype(np.float32)
    for step in (0, 500, 999, [3, 400, 998]):
        want = np.asarray(jax_solver.add_noise(jnp.asarray(x), jnp.asarray(noise), step))
        got = port_solver.add_noise(torch.tensor(nhwc_to_nchw(x)), torch.tensor(nhwc_to_nchw(noise)), step)
        assert float(np.abs(nchw_to_nhwc(got.numpy()) - want).max()) <= 1e-6
    with pytest.raises(NotImplementedError):
        port_solver(torch.tensor(x), torch.tensor(noise), 0)


# -- the Trainer against the JAX Trainer -------------------------------------------

EVENTS = sorted(name for name in vars(jtu.Callback) if name.startswith("on_"))


def _mock_batches() -> list[tuple[np.ndarray, np.ndarray]]:
    rs = np.random.RandomState(0)
    return [(rs.randn(4, 10).astype(np.float32), rs.randn(4, 10).astype(np.float32)) for _ in range(8)]


def _recorder(base: type, records: list[Any], snapshot: Any) -> Any:
    """A callback that logs every event, and at each optimizer step's end the
    learning rate, the grad norm and the trainable model's weights."""

    class Recorder(base):  # type: ignore[misc, valid-type]
        pass

    def make(name: str) -> Any:
        def event(self: Any, trainer: Any) -> None:
            records.append(name)
            if name == "on_optimizer_step_end":
                records.append((trainer.current_learning_rate("mock_model"), trainer.grad_norm, snapshot(trainer)))

        return event

    for name in EVENTS:
        setattr(Recorder, name, make(name))
    return Recorder()


class JaxMockConfig(jtu.BaseConfig):
    mock_model: jtu.ModelConfig
    mock_model_frozen: jtu.ModelConfig
    recorder: jtu.CallbackConfig = jtu.CallbackConfig()


class JaxMockTrainer(jtu.Trainer[JaxMockConfig, Any]):
    records: list[Any]

    @jtu.register_model()
    def mock_model(self, config: jtu.ModelConfig) -> jfl.Chain:
        return jfl.Chain(jfl.Linear(10, 10), jfl.Linear(10, 10), jfl.Linear(10, 10))

    @jtu.register_model()
    def mock_model_frozen(self, config: jtu.ModelConfig) -> jfl.Chain:
        return jfl.Chain(jfl.Linear(10, 10), jfl.Linear(10, 10), jfl.Linear(10, 10))

    @jtu.register_callback()
    def recorder(self, config: jtu.CallbackConfig) -> Any:
        self.records = []
        return _recorder(jtu.Callback, self.records, lambda t: {k: np.asarray(v) for k, v in t.mock_model.state_dict().items()})

    def create_data_iterable(self) -> list[tuple[jax.Array, jax.Array]]:
        return [(jnp.asarray(x), jnp.asarray(y)) for x, y in _mock_batches()]

    def compute_loss(self, batch: tuple[jax.Array, jax.Array]) -> jax.Array:
        return jnp.mean((self.mock_model(batch[0]) - batch[1]) ** 2)


class PortMockConfig(tu.BaseConfig):
    mock_model: tu.ModelConfig
    mock_model_frozen: tu.ModelConfig
    recorder: tu.CallbackConfig = tu.CallbackConfig()


def _port_state(trainer: Any) -> dict[str, np.ndarray]:
    """The trainable model's weights in the JAX layout (Linear: (in, out))."""
    return {k: v.detach().numpy().T.copy() for k, v in trainer.mock_model.state_dict().items()}


class PortMockTrainer(tu.Trainer[PortMockConfig, Any]):
    records: list[Any]

    @tu.register_model()
    def mock_model(self, config: tu.ModelConfig) -> fl.Chain:
        return fl.Chain(fl.Linear(10, 10), fl.Linear(10, 10), fl.Linear(10, 10))

    @tu.register_model()
    def mock_model_frozen(self, config: tu.ModelConfig) -> fl.Chain:
        return fl.Chain(fl.Linear(10, 10), fl.Linear(10, 10), fl.Linear(10, 10))

    @tu.register_callback()
    def recorder(self, config: tu.CallbackConfig) -> Any:
        self.records = []
        return _recorder(tu.Callback, self.records, _port_state)

    def create_data_iterable(self) -> list[tuple[torch.Tensor, torch.Tensor]]:
        return [(torch.tensor(x), torch.tensor(y)) for x, y in _mock_batches()]

    def compute_loss(self, batch: tuple[torch.Tensor, torch.Tensor]) -> torch.Tensor:
        return torch.mean((self.mock_model(batch[0]) - batch[1]) ** 2)


def _configure(config: Any, package: Any, case: str) -> None:
    config.training.duration = package.Epoch(2)
    if case == "adamw":
        config.optimizer.optimizer = package.Optimizers.AdamW
        config.mock_model.learning_rate = 0.05
        config.training.gradient_clipping_max_norm = 0.1
        config.lr_scheduler.warmup = package.Step(2)


@pytest.mark.parametrize("case", ["sgd", "adamw"])
def test_trainer_matches_the_jax_trainer_step_by_step(case: str) -> None:
    """`mock_config.toml` (SGD, warmup, accumulation 4, clipping 1.0), and
    AdamW with a per-model learning rate and active clipping: both trainers
    from the same weights over the same 8 batches, 2 epochs (4 optimizer
    steps)."""
    jax_config = JaxMockConfig.load_from_toml(MOCK_TOML)
    port_config = PortMockConfig.load_from_toml(MOCK_TOML)
    port_config.training.device = "cpu"
    _configure(jax_config, jtu, case)
    _configure(port_config, tu, case)
    jax_trainer, port_trainer = JaxMockTrainer(jax_config), PortMockTrainer(port_config)
    for name in ("mock_model", "mock_model_frozen"):
        load_jax_state_dict(getattr(port_trainer, name), {k: np.asarray(v) for k, v in getattr(jax_trainer, name).state_dict().items()})
    frozen = {k: v.clone() for k, v in port_trainer.mock_model_frozen.state_dict().items()}
    initial = _port_state(port_trainer)
    jax_trainer.train()
    port_trainer.train()

    jax_records, port_records = jax_trainer.records, port_trainer.records
    assert [r for r in port_records if isinstance(r, str)] == [r for r in jax_records if isinstance(r, str)]
    jax_steps = [r for r in jax_records if isinstance(r, tuple)]
    port_steps = [r for r in port_records if isinstance(r, tuple)]
    assert len(port_steps) == len(jax_steps) == 4
    for (lr, norm, state), (jax_lr, jax_norm, jax_state) in zip(port_steps, jax_steps):
        assert lr == pytest.approx(jax_lr, rel=TRAINER_TOL, abs=1e-12)
        assert norm == pytest.approx(jax_norm, rel=TRAINER_TOL)
        for key, want in jax_state.items():
            assert _rel(state[key], want) <= TRAINER_TOL, key
    for key, value in port_trainer.mock_model_frozen.state_dict().items():
        assert torch.equal(value, frozen[key])
    for attr in ("step", "epoch", "iteration", "num_batches_processed", "num_minibatches_processed"):
        assert getattr(port_trainer.clock, attr) == getattr(jax_trainer.clock, attr), attr
    assert all(not np.allclose(port_steps[-1][2][k], v) for k, v in initial.items())


# -- config ---------------------------------------------------------------------


def test_mock_config_loads_as_in_jax() -> None:
    port, jax_config = tu.BaseConfig.load_from_toml, JaxMockConfig.load_from_toml(MOCK_TOML)
    config = PortMockConfig.load_from_toml(MOCK_TOML)
    assert port is not None and config.training.device == "cuda"  # explicit: no silent CPU default
    for section in ("training", "optimizer", "lr_scheduler", "clock"):
        jax_section = dict(getattr(jax_config, section))
        for key, value in getattr(config, section):
            if key in ("device", "mesh"):
                continue
            want = jax_section[key]
            if isinstance(want, jtu.TimeValue):
                assert (type(value).__name__, value.number) == (type(want).__name__, want.number), key
            elif hasattr(want, "value"):  # enums
                assert value.value == want.value, key
            else:
                assert value == want, key
    assert config.mock_model.requires_grad is True and config.mock_model_frozen.requires_grad is False


@pytest.mark.parametrize("text", ["100:epoch", "4:step", "20:iteration", "7: Step", 12])
def test_time_values_parse_as_in_jax(text: str | int) -> None:
    got, want = tu.parse_number_unit_field(text), jtu.common.parse_number_unit_field(text)
    assert (type(got).__name__, got.number) == (type(want).__name__, want.number)


@pytest.mark.parametrize(
    "toml",
    [
        'bogus = 1\n[training]\n[optimizer]\noptimizer = "SGD"\n[lr_scheduler]\n',
        '[training]\nbogus = 1\n[optimizer]\noptimizer = "SGD"\n[lr_scheduler]\n',
        '[training]\n[optimizer]\noptimizer = "SGD"\nmomentum = 0.9\n[lr_scheduler]\n',
    ],
)
def test_unknown_keys_are_refused(toml: str) -> None:
    with pytest.raises(ValueError, match="bogus|momentum"):
        tu.BaseConfig.load_from_toml_string(toml)


def test_what_is_not_ported_raises_naming_the_roadmap() -> None:
    base = '[optimizer]\noptimizer = "{}"\n[lr_scheduler]\n[training]\n'
    # the optimizers that raised here before they were ported now build their torch optimizer
    for name, optimizer in (("AdamW8bit", torch.optim.AdamW), ("Lion8bit", tu.Lion), ("Prodigy", tu.Prodigy)):
        config = tu.BaseConfig.load_from_toml_string(base.format(name))
        assert isinstance(config.optimizer.get(torch.nn.Linear(2, 2).parameters()), optimizer)
    # [training.mesh] is ported: it parses as the JAX package's MeshConfig does, unknown keys refused;
    # jit_step is ported (a compiled step: tests/test_torch_graphs.py): it parses as the JAX package's
    mesh = tu.BaseConfig.load_from_toml_string(base.format("SGD") + "[training.mesh]\ntensor = 2\n").training.mesh
    jax_mesh = jtu.config.MeshConfig(tensor=2)
    assert (mesh.data, mesh.tensor, mesh.tensor_parallel_rules) == (jax_mesh.data, jax_mesh.tensor, jax_mesh.tensor_parallel_rules)
    with pytest.raises(ValueError, match="bogus"):
        tu.BaseConfig.load_from_toml_string(base.format("SGD") + "[training.mesh]\nbogus = 2\n")
    training = tu.BaseConfig.load_from_toml_string(base.format("SGD") + "jit_step = true\n").training
    assert training.jit_step is True and jtu.config.TrainingConfig(jit_step=True).jit_step is True
    defaults, jax_defaults = tu.OptimizerConfig(optimizer="AdamW"), jtu.OptimizerConfig(optimizer="AdamW")
    for key in ("learning_rate", "betas", "eps", "weight_decay"):
        assert getattr(defaults, key) == getattr(jax_defaults, key)


# -- the training example ------------------------------------------------------------


def test_train_unet_example_takes_steps_on_the_cpu() -> None:
    from refiners_tpu_torch.examples.train_unet import CONFIG, UnetConfig, UnetTrainer

    toml = CONFIG.replace('device = "cuda"', 'device = "cpu"').replace('"100:step"', '"2:step"')
    toml = toml.replace('"4:step"', '"1:step"').replace('warmup = "10:step"', "").replace("1e-5", "1e-3")
    trainer = UnetTrainer(UnetConfig.load_from_toml_string(toml), base_channels=32, batch_size=2, latent_size=16, num_batches=2)
    before = {k: v.clone() for k, v in trainer.unet.state_dict().items()}
    trainer.train()
    assert trainer.clock.iteration == 2 and np.isfinite(float(trainer.loss.detach())) and np.isfinite(trainer.grad_norm)
    changed = [k for k, v in trainer.unet.state_dict().items() if v.ndim >= 2 and not torch.equal(v, before[k])]
    assert len(changed) == sum(1 for v in before.values() if v.ndim >= 2)


# -- imports ---------------------------------------------------------------------------


def test_the_port_imports_no_jax_pydantic_optax_or_safetensors() -> None:
    code = (
        "import importlib, pkgutil, sys, refiners_tpu_torch\n"
        "for m in pkgutil.walk_packages(refiners_tpu_torch.__path__, 'refiners_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "print(sorted(n for n in ('jax', 'pydantic', 'optax', 'safetensors') if n in sys.modules))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
