"""The port's LoRA layers and `SDLoraManager` against the JAX package, on the CPU.

The cases of `tests/adapters/test_lora.py` and `test_lora_manager.py`, held
against JAX. LoRA weights are given in the reference (torch) layout, as
CivitAI files hold them: one dict of numpy arrays feeds both packages.
`SDLoraManager` runs on the JAX tests' reduced `StableDiffusion_1`
(`SD1UNet(base_channels=32)`, a 2-layer CLIP-L), built in JAX from a seed
and bridged into the port. Float32 on both sides: 1e-4 relative (one UNet
call, or the text encoder); ejecting restores the base output bit for bit.
"""

from __future__ import annotations

from typing import Any

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import refiners_tpu.fluxion.layers as jfl
import refiners_tpu_torch.fluxion.layers as fl
from refiners_tpu.fluxion import manual_seed as jax_manual_seed
from refiners_tpu.fluxion.adapters import LinearLora as JaxLinearLora
from refiners_tpu.fluxion.adapters import Lora as JaxLora
from refiners_tpu.fluxion.adapters import LoraAdapter as JaxLoraAdapter
from refiners_tpu.foundationals.clip import CLIPTextEncoder as JaxCLIPTextEncoder
from refiners_tpu.foundationals.latent_diffusion import DDIM as JaxDDIM
from refiners_tpu.foundationals.latent_diffusion import SD1UNet as JaxSD1UNet
from refiners_tpu.foundationals.latent_diffusion import SDLoraManager as JaxSDLoraManager
from refiners_tpu.foundationals.latent_diffusion import StableDiffusion_1 as JaxStableDiffusion_1
from refiners_tpu.foundationals.latent_diffusion.stable_diffusion_1 import SD1Autoencoder as JaxSD1Autoencoder
from refiners_tpu_torch.conversion import load_jax_state_dict, nchw_to_nhwc, nhwc_to_nchw
from refiners_tpu_torch.fluxion.adapters import Conv2dLora, LinearLora, Lora, LoraAdapter, auto_attach_loras
from refiners_tpu_torch.foundationals.clip import CLIPTextEncoder
from refiners_tpu_torch.foundationals.latent_diffusion import (
    DDIM,
    SD1Autoencoder,
    SD1UNet,
    SDLoraManager,
    StableDiffusion_1,
)
from refiners_tpu_torch.foundationals.latent_diffusion.cross_attention import CrossAttentionBlock
from refiners_tpu_torch.foundationals.latent_diffusion.unet import ResidualBlock

TOL = 1e-4
RANK = 4


@pytest.fixture(autouse=True, scope="module")
def _torch_threads() -> Any:
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _rel(got: np.ndarray, want: np.ndarray) -> float:
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _bridge(jax_module: Any, port_module: torch.nn.Module) -> None:
    load_jax_state_dict(port_module, {k: np.asarray(v) for k, v in jax_module.state_dict().items()})


# -- the layers (tests/adapters/test_lora.py) --------------------------------


def test_properties_and_torch_layout() -> None:
    lora = LinearLora("test", in_features=320, out_features=128, rank=16)
    assert (lora.name, lora.rank, lora.scale) == ("test", 16, 1.0)
    assert lora.in_features == lora.down.in_features == 320
    assert lora.out_features == lora.up.out_features == 128
    assert lora.down.weight.shape == (16, 320) and lora.up.weight.shape == (128, 16)
    assert list(lora.state_dict()) == list(JaxLinearLora("test", 320, 128, rank=16).state_dict())


def test_init_is_the_identity_delta() -> None:
    lora = LinearLora("test", 320, 128, rank=16)
    down, up = lora.checkpoint_weights()
    assert float(up.abs().sum()) == 0.0 and float(down.abs().sum()) > 0.0
    assert abs(float(down.std()) - 1 / 16) < 0.1 / 16
    assert float(lora(torch.ones(1, 320)).abs().sum()) == 0.0
    conv = Conv2dLora("conv_test", in_channels=16, out_channels=8, rank=4)
    out = conv(torch.ones(1, 16, 8, 8))
    assert out.shape == (1, 8, 8, 8) and float(out.abs().sum()) == 0.0


def test_scale_setter() -> None:
    lora = LinearLora("test", 32, 8, rank=2)
    lora.scale = 2.0
    assert lora.scale == 2.0 and lora.ensure_find(fl.Multiply).scale == 2.0


def _torch_layout_weights(shapes: dict[str, tuple[tuple[int, ...], tuple[int, ...]]], seed: int) -> dict[str, np.ndarray]:
    """A reference-layout dict: for each key, `key.lora_down.weight` then `key.lora_up.weight`."""
    rs = np.random.RandomState(seed)
    weights: dict[str, np.ndarray] = {}
    for key, (down, up) in shapes.items():
        weights[f"{key}.lora_down.weight"] = (rs.randn(*down) * 0.1).astype(np.float32)
        weights[f"{key}.lora_up.weight"] = (rs.randn(*up) * 0.1).astype(np.float32)
    return weights


@pytest.mark.parametrize(
    "down, up, x_shape",
    [((16, 320), (128, 16), (2, 320)), ((4, 16, 3, 3), (8, 4, 1, 1), (1, 7, 9, 16)),
     ((4, 16, 1, 1), (8, 4, 3, 3), (2, 6, 6, 16)), ((2, 6, 1, 1), (5, 2, 1, 1), (1, 4, 4, 6))],
)  # fmt: skip
def test_from_weights_matches_jax(down: tuple[int, ...], up: tuple[int, ...], x_shape: tuple[int, ...]) -> None:
    """One torch-layout pair loaded by both packages: the same LoRA type,
    kernel sizes and paddings, and output (Linear: x·downᵀ·upᵀ)."""
    w = _torch_layout_weights({"k": (down, up)}, seed=1)
    d, u = w["k.lora_down.weight"], w["k.lora_up.weight"]
    jax_lora = JaxLora.from_weights("w", down=jnp.asarray(d), up=jnp.asarray(u))
    lora = Lora.from_weights("w", down=torch.tensor(d), up=torch.tensor(u))
    assert type(lora).__name__ == type(jax_lora).__name__ and lora.rank == jax_lora.rank == down[0]
    x = np.random.RandomState(2).randn(*x_shape).astype(np.float32)
    spatial = len(x_shape) == 4
    if spatial:
        assert lora.kernel_size == jax_lora.kernel_size and lora.padding == jax_lora.padding
    with torch.no_grad():
        got = lora(torch.tensor(nhwc_to_nchw(x) if spatial else x)).numpy()
    want = np.asarray(jax_lora(jnp.asarray(x)))
    assert _rel(nchw_to_nhwc(got) if spatial else got, want) <= TOL
    if not spatial:
        assert _rel(got, x @ d.T @ u.T) <= TOL
    # the port hands the checkpoint layout back as it took it
    for got_w, want_w in zip(lora.checkpoint_weights(), (d, u)):
        np.testing.assert_array_equal(got_w.numpy(), want_w)


def test_from_dict() -> None:
    state_dict = {
        "a.down.weight": torch.zeros(4, 8),
        "a.up.weight": torch.zeros(8, 4),
        "b.down.weight": torch.zeros(4, 16, 1, 1),
        "b.up.weight": torch.zeros(16, 4, 3, 3),
        "b.alpha": torch.tensor(4.0),
    }
    loras = Lora.from_dict("test", state_dict)
    assert list(loras.keys()) == ["a", "b"]
    assert isinstance(loras["a"], LinearLora) and isinstance(loras["b"], Conv2dLora)
    assert loras["b"].kernel_size == (1, 3) and loras["b"].padding == (0, 1)
    assert loras["a"].down.weight.dtype == torch.float32
    half = Lora.from_dict("h", {k: v.half() for k, v in state_dict.items() if k.startswith("a")})
    assert half["a"].up.weight.dtype == torch.float16


def test_lora_adapter_matches_jax() -> None:
    """Wrapped, the adapter adds the LoRA to its target as JAX's does; more
    LoRAs add and remove by name; ejecting restores the target."""
    chains = [ns.Chain(ns.Chain(ns.Linear(32, 16))) for ns in (jfl, fl)]
    _bridge(chains[0], chains[1])
    x = np.random.RandomState(3).randn(2, 32).astype(np.float32)
    with torch.no_grad():
        base = chains[1](torch.tensor(x))
    w = _torch_layout_weights({"t": ((4, 32), (16, 4)), "s": ((2, 32), (16, 2))}, seed=4)
    jax_adapter = JaxLoraAdapter(
        chains[0].Chain.Linear, JaxLora.from_weights("t", jnp.asarray(w["t.lora_down.weight"]), jnp.asarray(w["t.lora_up.weight"]))
    ).inject(chains[0].Chain)
    adapter = LoraAdapter(
        chains[1].Chain.Linear, Lora.from_weights("t", torch.tensor(w["t.lora_down.weight"]), torch.tensor(w["t.lora_up.weight"]))
    ).inject(chains[1].Chain)
    assert list(chains[1].state_dict()) == list(chains[0].state_dict())
    assert adapter.names == ["t"] and adapter.scales == {"t": 1.0}
    second = [cls.from_weights("s", wrap(w["s.lora_down.weight"]), wrap(w["s.lora_up.weight"]))
              for cls, wrap in ((JaxLora, jnp.asarray), (Lora, torch.tensor))]  # fmt: skip
    jax_adapter.add_lora(second[0])
    adapter.add_lora(second[1])
    jax_adapter.scale = {"t": 0.5, "s": 2.0}
    adapter.scale = {"t": 0.5, "s": 2.0}
    assert adapter.names == ["t", "s"] and adapter.scales == {"t": 0.5, "s": 2.0}
    with torch.no_grad():
        got = chains[1](torch.tensor(x)).numpy()
    assert _rel(got, np.asarray(chains[0](jnp.asarray(x)))) <= TOL
    assert not np.allclose(got, base.numpy())
    assert adapter.remove_lora("s") is second[1] and adapter.names == ["t"] and adapter.remove_lora("nope") is None
    adapter.eject()
    assert chains[1].Chain[0] is adapter.target
    with torch.no_grad():
        assert torch.equal(chains[1](torch.tensor(x)), base)


def test_conv2d_lora_adapter_matches_jax() -> None:
    """A Conv2dLora on a strided convolution takes the target's stride."""
    chains = [ns.Chain(ns.Conv2d(8, 6, kernel_size=3, stride=2, padding=1), ns.SiLU()) for ns in (jfl, fl)]
    _bridge(chains[0], chains[1])
    w = _torch_layout_weights({"c": ((3, 8, 3, 3), (6, 3, 1, 1))}, seed=5)
    d, u = w["c.lora_down.weight"], w["c.lora_up.weight"]
    jax_lora, lora = JaxLora.from_weights("c", jnp.asarray(d), jnp.asarray(u)), Lora.from_weights("c", torch.tensor(d), torch.tensor(u))
    for l, chain in ((jax_lora, chains[0]), (lora, chains[1])):
        adapter, parent = l.auto_attach(chain)
        adapter.inject(parent)
    assert lora.down.stride == (2, 2) and isinstance(chains[1][0], LoraAdapter)
    x = np.random.RandomState(6).randn(2, 9, 9, 8).astype(np.float32)
    with torch.no_grad():
        got = nchw_to_nhwc(chains[1](torch.tensor(nhwc_to_nchw(x))).numpy())
    want = np.asarray(chains[0](jnp.asarray(x)))
    assert got.shape == want.shape == (2, 5, 5, 6) and _rel(got, want) <= TOL


def test_auto_attach() -> None:
    model = fl.Chain(fl.Chain(fl.Linear(320, 128)), fl.Linear(128, 64))
    attached = LinearLora("test", in_features=320, out_features=128, rank=16).auto_attach(model)
    assert attached is not None
    adapter, parent = attached
    assert parent is model.Chain
    adapter.inject(parent)
    assert isinstance(model.Chain[0], LoraAdapter)
    # a LoRA of another name joins the adapter in place
    again = LinearLora("other", 320, 128, rank=2).auto_attach(model)
    assert again == (adapter, None) and adapter.names == ["test", "other"]


def test_auto_attach_loras_sanity_and_failure() -> None:
    model = fl.Chain(fl.Chain(fl.Linear(16, 16)), fl.Linear(16, 8))
    loras = {"l1": LinearLora("n1", 16, 16, rank=4), "l2": LinearLora("n2", 16, 8, rank=4)}
    assert auto_attach_loras(loras, model, sanity_check=True) == []
    assert isinstance(model.Chain[0], LoraAdapter) and isinstance(model[1], LoraAdapter)
    assert auto_attach_loras({"l1": LinearLora("n1", 999, 999, rank=4)}, fl.Chain(fl.Linear(16, 16)), sanity_check=False) == ["l1"]
    # a LoRA for one of two Linears of the same shape: its copy would attach to the other
    with pytest.raises(ValueError, match="attached twice"):
        auto_attach_loras({"l": LinearLora("n", 16, 16, rank=2)}, fl.Chain(fl.Linear(16, 16), fl.Linear(16, 16)))


def test_gradients_reach_the_lora_weights() -> None:
    target = fl.Linear(8, 8)
    lora = LinearLora("t", 8, 8, rank=2)
    with torch.no_grad():
        lora.up.weight.fill_(1.0)
    chain = fl.Chain(target)
    LoraAdapter(target, lora).inject(chain)
    target.weight.requires_grad_(False)
    (chain(torch.ones(2, 8)) ** 2).sum().backward()
    assert float(lora.down.weight.grad.abs().sum()) > 0 and target.weight.grad is None


# -- SDLoraManager (tests/adapters/test_lora_manager.py) ----------------------


@pytest.fixture(scope="module")
def models() -> tuple[Any, StableDiffusion_1]:
    jax_manual_seed(0)
    jax_sd = JaxStableDiffusion_1(
        unet=JaxSD1UNet(in_channels=4, base_channels=32),
        lda=JaxSD1Autoencoder(),
        clip_text_encoder=JaxCLIPTextEncoder(embedding_dim=768, num_layers=2, num_attention_heads=12),
        solver=JaxDDIM(num_inference_steps=10),
    )
    port_sd = StableDiffusion_1(
        unet=SD1UNet(in_channels=4, base_channels=32),
        lda=SD1Autoencoder(),
        clip_text_encoder=CLIPTextEncoder(embedding_dim=768, num_layers=2, num_attention_heads=12),
        solver=DDIM(num_inference_steps=10),
        device="cpu",
    )
    for name in ("unet", "clip_text_encoder"):
        _bridge(getattr(jax_sd, name), getattr(port_sd, name))
    return jax_sd, port_sd


def _sd_lora_dict(sd: StableDiffusion_1, seed: int) -> dict[str, np.ndarray]:
    """A CivitAI-style dict in the reference layout: every Linear of the
    UNet's transformer blocks (attention and feed-forward) and of CLIP, and
    every convolution of the UNet's ResidualBlocks ("res" keys, 3×3 down,
    1×1 up), named in the order of the tree so that each key attaches to its layer."""
    shapes: dict[str, tuple[tuple[int, ...], tuple[int, ...]]] = {}
    linears = [l for block in sd.unet.layers(CrossAttentionBlock, recurse=True) for l in block.layers(fl.Linear, recurse=True)]
    for n, linear in enumerate(linears):
        shapes[f"lora_unet_L{n:04d}"] = ((RANK, linear.in_features), (linear.out_features, RANK))
    convs = [c for block in sd.unet.layers(ResidualBlock, recurse=True) for c in block.layers(fl.Conv2d, recurse=True)]
    for n, conv in enumerate(convs):
        shapes[f"lora_unet_res_R{n:04d}"] = ((RANK, conv.in_channels, 3, 3), (conv.out_channels, RANK, 1, 1))
    for n, linear in enumerate(sd.clip_text_encoder.layers(fl.Linear, recurse=True)):
        shapes[f"lora_text_T{n:04d}"] = ((RANK, linear.in_features), (linear.out_features, RANK))
    return _torch_layout_weights(shapes, seed)


@pytest.fixture(scope="module")
def lora_dicts(models: tuple[Any, StableDiffusion_1]) -> dict[str, dict[str, np.ndarray]]:
    return {"style": _sd_lora_dict(models[1], seed=7), "detail": _sd_lora_dict(models[1], seed=8)}


@pytest.fixture(scope="module")
def inputs() -> dict[str, np.ndarray]:
    rs = np.random.RandomState(9)
    return {"x": rs.randn(2, 16, 16, 4).astype(np.float32), "emb": rs.randn(2, 77, 768).astype(np.float32)}


_jax_unet_call = jax.jit(
    lambda unet, x, e: (unet.set_timestep(jnp.asarray([500])), unet.set_clip_text_embedding(e), unet(x))[-1]
)


def _port_unet(port_sd: StableDiffusion_1, inputs: dict[str, np.ndarray]) -> np.ndarray:
    """One UNet call (batch 2, timestep 500), NHWC."""
    with torch.no_grad():
        port_sd.unet.set_timestep(torch.tensor([500]))
        port_sd.unet.set_clip_text_embedding(torch.tensor(inputs["emb"]))
        return nchw_to_nhwc(port_sd.unet(torch.tensor(nhwc_to_nchw(inputs["x"]))).numpy())


def _unets(models: tuple[Any, StableDiffusion_1], inputs: dict[str, np.ndarray]) -> tuple[np.ndarray, np.ndarray]:
    """The same UNet call in the port, then in JAX."""
    want = _jax_unet_call(models[0].unet, jnp.asarray(inputs["x"]), jnp.asarray(inputs["emb"]))
    return _port_unet(models[1], inputs), np.asarray(want)


def _port_text(port_sd: StableDiffusion_1) -> np.ndarray:
    with torch.no_grad():
        return port_sd.compute_clip_text_embedding("a cute cat", negative_text="blurry").numpy()


def _text(models: tuple[Any, StableDiffusion_1]) -> tuple[np.ndarray, np.ndarray]:
    want = models[0].compute_clip_text_embedding("a cute cat", negative_text="blurry")
    return _port_text(models[1]), np.asarray(want)


@pytest.fixture()
def managers(models: tuple[Any, StableDiffusion_1]) -> Any:
    jax_manager, manager = JaxSDLoraManager(models[0]), SDLoraManager(models[1])
    yield jax_manager, manager
    jax_manager.remove_all()
    manager.remove_all()
    assert manager.lora_adapters == [] and list(models[1].unet.layers(LoraAdapter, recurse=True)) == []


def _add(managers: Any, name: str, weights: dict[str, np.ndarray], scale: float) -> None:
    jax_manager, manager = managers
    jax_manager.add_loras(name, tensors={k: jnp.asarray(v) for k, v in weights.items()}, scale=scale)
    manager.add_loras(name, tensors={k: torch.tensor(v) for k, v in weights.items()}, scale=scale)


def test_manager_matches_jax_at_two_scales(
    models: tuple[Any, StableDiffusion_1], managers: Any, lora_dicts: dict[str, dict[str, np.ndarray]],
    inputs: dict[str, np.ndarray],
) -> None:  # fmt: skip
    """Two LoRAs from one reference-layout dict each, loaded by both
    managers: the same layers take them (the same state dict keys), and the
    UNet output and text embedding match JAX's at scales (1.0, 0.5), then
    at (0.3, -0.8); removing one LoRA matches JAX's too."""
    jax_manager, manager = managers
    base_unet, base_text = _port_unet(models[1], inputs), _port_text(models[1])
    _add(managers, "style", lora_dicts["style"], 1.0)
    _add(managers, "detail", lora_dicts["detail"], 0.5)
    n_layers = len(lora_dicts["style"]) // 2
    assert len(manager.loras) == len(jax_manager.loras) == 2 * n_layers
    assert list(models[1].unet.state_dict()) == list(models[0].unet.state_dict())
    assert list(models[1].clip_text_encoder.state_dict()) == list(models[0].clip_text_encoder.state_dict())
    assert sorted(manager.names) == ["detail", "style"] and manager.scales == {"style": 1.0, "detail": 0.5}
    adapter = manager.lora_adapters[0]
    assert sorted(adapter.names) == ["detail", "style"]

    for scales in ({"style": 1.0, "detail": 0.5}, {"style": 0.3, "detail": -0.8}):
        jax_manager.update_scales(scales)
        manager.update_scales(scales)
        assert manager.scales == scales
        got, want = _unets(models, inputs)
        assert _rel(got, want) <= TOL and _rel(got, base_unet) > 1e-3
        got, want = _text(models)
        assert _rel(got, want) <= TOL and _rel(got, base_text) > 1e-3

    jax_manager.remove_loras("style")
    manager.remove_loras("style")
    assert manager.names == ["detail"] and len(manager.loras) == n_layers
    got, want = _unets(models, inputs)
    assert _rel(got, want) <= TOL


def test_manager_lora_weights_round_trip(
    models: tuple[Any, StableDiffusion_1], managers: Any, lora_dicts: dict[str, dict[str, np.ndarray]]
) -> None:
    """`get_lora_weights` gives back every array of the dict, in the torch
    layout, under the JAX manager's keys (which hold JAX's layout)."""
    jax_manager, manager = managers
    _add(managers, "style", lora_dicts["style"], 1.0)
    stored = manager.get_lora_weights("style")
    jax_stored = jax_manager.get_lora_weights("style")
    assert list(stored) == list(jax_stored) and len(stored) == len(lora_dicts["style"])
    for key, value in stored.items():
        want = np.asarray(jax_stored[key])
        want = want.T if want.ndim == 2 else want.transpose(3, 2, 0, 1)
        np.testing.assert_array_equal(value.numpy(), want)
    given = sorted(v.tobytes() for v in lora_dicts["style"].values())
    assert sorted(v.numpy().tobytes() for v in stored.values()) == given
    with pytest.raises(AssertionError, match="already exists"):
        manager.add_loras("style", tensors={k: torch.tensor(v) for k, v in lora_dicts["style"].items()})


def test_manager_remove_restores_the_base_model(
    models: tuple[Any, StableDiffusion_1], managers: Any, lora_dicts: dict[str, dict[str, np.ndarray]],
    inputs: dict[str, np.ndarray],
) -> None:  # fmt: skip
    """A LoRA at scale 0 leaves the output as it was; `remove_loras` of every
    name and `remove_all` eject every adapter and restore the base output bit
    for bit (the port alone: the JAX manager follows for the fixture's teardown)."""
    _, manager = managers
    base, base_text = _port_unet(models[1], inputs), _port_text(models[1])
    for names in (("style", "detail"), None):
        _add(managers, "style", lora_dicts["style"], 0.0)
        _add(managers, "detail", lora_dicts["detail"], 0.0)
        np.testing.assert_array_equal(_port_unet(models[1], inputs), base)
        manager.update_scales({"detail": 0.7})
        assert np.abs(_port_unet(models[1], inputs) - base).max() > 1e-4
        if names is None:
            manager.remove_all()
            managers[0].remove_all()
        else:
            manager.remove_loras(*names)
            managers[0].remove_loras(*names)
        assert manager.names == [] and manager.lora_adapters == []
        np.testing.assert_array_equal(_port_unet(models[1], inputs), base)
        np.testing.assert_array_equal(_port_text(models[1]), base_text)


def test_manager_sort_keys_matches_jax() -> None:
    keys = ["lora_unet_up_1_out", "lora_unet_up_10_q", "lora_unet_up_2_k", "lora_unet_up_2_q", "lora_te_1_v_lora", "x_in"]
    assert sorted(keys, key=SDLoraManager.sort_keys) == sorted(keys, key=JaxSDLoraManager.sort_keys)
    assert SDLoraManager.sort_keys("lora_unet_up_2_q") == ("lora_unet_up_02", 1)
