"""The port's inference rewrite passes (`fluxion/optimization.py`) against the
JAX package, on the CPU: GroupNorm+SiLU fusion, QKV fusion and int8
quantization of whole models.

JAX modules are built from a seed and bridged into the port; inputs are
numpy arrays handed to both. The JAX side runs its GroupNorm kernel through
the Pallas interpreter, as tests/fluxion/test_group_norm_fusion.py does; the
port's fused layers run the plain versions of K5 on CPU tensors.
"""

from __future__ import annotations

from typing import Any

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

import refiners_tpu.fluxion.layers as jfl
import refiners_tpu.fluxion.optimization as jopt
import refiners_tpu_torch.fluxion.layers as fl
import refiners_tpu_torch.fluxion.optimization as opt
from refiners_tpu.fluxion import manual_seed as jax_manual_seed
from refiners_tpu.foundationals.latent_diffusion import SDXLAutoencoder as JaxSDXLAutoencoder
from refiners_tpu.foundationals.latent_diffusion import SDXLUNet as JaxSDXLUNet
from refiners_tpu.foundationals.latent_diffusion.unet import ResidualBlock as JaxResidualBlock
from refiners_tpu_torch.conversion import load_jax_state_dict, nchw_to_nhwc, nhwc_to_nchw
from refiners_tpu_torch.foundationals.latent_diffusion import SDXLAutoencoder, SDXLUNet
from refiners_tpu_torch.foundationals.latent_diffusion.unet import ResidualBlock

# one module in float32 on both sides: summation order only
MODULE_TOL = 1e-5
# a whole reduced UNet: float noise amplified through its depth (as tests/test_torch_sdxl.py)
UNET_TOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _torch_threads() -> Any:
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _rel(got: np.ndarray, want: np.ndarray) -> float:
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _bridged(jax_module: Any, port_module: torch.nn.Module) -> torch.nn.Module:
    load_jax_state_dict(port_module, {k: np.asarray(v) for k, v in jax_module.state_dict().items()})
    return port_module


def _state(module: Any) -> dict[str, np.ndarray]:
    return {k: np.asarray(v) for k, v in module.state_dict().items()}


# ---------------------------------------------------------------------------
# GroupNorm + SiLU
# ---------------------------------------------------------------------------


def _mini_residual_chain(package: Any) -> Any:
    """The JAX test's chain: two GN → SiLU → Conv halves and a trailing GN
    with no SiLU, which must not fuse."""
    return package.Chain(
        package.GroupNorm(channels=32, num_groups=8),
        package.SiLU(),
        package.Conv2d(in_channels=32, out_channels=32, kernel_size=3, padding=1),
        package.GroupNorm(channels=32, num_groups=8),
        package.SiLU(),
        package.Conv2d(in_channels=32, out_channels=32, kernel_size=3, padding=1),
        package.GroupNorm(channels=32, num_groups=8),
    )


def _mini_pair() -> tuple[Any, Any]:
    jax_manual_seed(7)
    jax_chain = _mini_residual_chain(jfl)
    return jax_chain, _bridged(jax_chain, _mini_residual_chain(fl))


def test_fuse_group_norm_silu_matches_jax() -> None:
    jax_chain, chain = _mini_pair()
    x = np.random.RandomState(8).randn(1, 6, 6, 32).astype(np.float32)
    with torch.no_grad():
        unfused = chain(torch.tensor(nhwc_to_nchw(x))).numpy()

    assert jopt.fuse_group_norm_silu(jax_chain) == opt.fuse_group_norm_silu(chain) == 2
    assert len(list(chain.layers(opt.FusedGroupNormSiLU))) == 2
    assert len(list(chain.layers(fl.SiLU))) == 0
    assert len(list(chain.layers(fl.GroupNorm))) == 1  # the unpaired one survives
    assert repr(chain) == repr(jax_chain)
    assert list(chain.state_dict()) == list(jax_chain.state_dict())

    with pltpu.force_tpu_interpret_mode():
        want = nhwc_to_nchw(np.asarray(jax_chain(jnp.asarray(x))))
    with torch.no_grad():
        got = chain(torch.tensor(nhwc_to_nchw(x))).numpy()
    np.testing.assert_allclose(got, want, atol=MODULE_TOL)
    np.testing.assert_allclose(got, unfused, atol=MODULE_TOL)


def test_unfuse_group_norm_silu_restores_structure_and_weights() -> None:
    jax_chain, chain = _mini_pair()
    before_repr = repr(chain)
    before = {k: v.clone() for k, v in chain.state_dict().items()}
    weights = [p for p in chain.parameters()]

    opt.fuse_group_norm_silu(chain)
    assert all(any(p is q for q in chain.parameters()) for p in weights)  # shared, not copied
    assert opt.unfuse_group_norm_silu(chain) == 2
    jopt.fuse_group_norm_silu(jax_chain)
    assert jopt.unfuse_group_norm_silu(jax_chain) == 2
    assert repr(chain) == before_repr == repr(jax_chain)
    after = chain.state_dict()
    assert list(after) == list(before) == list(jax_chain.state_dict())
    for key, value in before.items():
        assert torch.equal(after[key], value), key
    assert [type(m) for m in chain] == [fl.GroupNorm, fl.SiLU, fl.Conv2d, fl.GroupNorm, fl.SiLU, fl.Conv2d, fl.GroupNorm]


def test_fuse_group_norm_silu_on_a_residual_block_matches_jax() -> None:
    jax_manual_seed(9)
    jax_block = JaxResidualBlock(in_channels=32, out_channels=64, num_groups=8)
    block = _bridged(jax_block, ResidualBlock(in_channels=32, out_channels=64, num_groups=8))
    assert jopt.fuse_group_norm_silu(jax_block) == opt.fuse_group_norm_silu(block) == 2
    x = np.random.RandomState(10).randn(1, 8, 8, 32).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        want = nhwc_to_nchw(np.asarray(jax_block(jnp.asarray(x))))
    with torch.no_grad():
        got = block(torch.tensor(nhwc_to_nchw(x))).numpy()
    np.testing.assert_allclose(got, want, atol=MODULE_TOL)


def test_sdxl_vae_fuses_21_encoder_and_29_decoder_pairs() -> None:
    """The full-width SDXL VAE, as `chip_smoke.py` fuses it; the fused JAX
    state dict loads into the fused port with strict=True."""
    jax_manual_seed(0)
    jax_vae = JaxSDXLAutoencoder()
    vae = _bridged(jax_vae, SDXLAutoencoder())
    assert [jopt.fuse_group_norm_silu(part) for part in jax_vae] == [21, 29]
    assert [opt.fuse_group_norm_silu(part) for part in vae] == [21, 29]
    fresh = SDXLAutoencoder(device="meta")
    assert opt.fuse_group_norm_silu(fresh) == 50
    assert list(fresh.state_dict()) == list(jax_vae.state_dict())
    load_jax_state_dict(vae, _state(jax_vae), strict=True)


def _unet_inputs() -> dict[str, np.ndarray]:
    rs = np.random.RandomState(0)
    return {
        "x": rs.randn(2, 16, 16, 4).astype(np.float32),
        "timestep": np.array([500], dtype=np.int32),
        "clip_text_embedding": rs.randn(2, 77, 2048).astype(np.float32),
        "pooled_text_embedding": rs.randn(2, 1280).astype(np.float32),
        "time_ids": np.array([[1024, 1024, 0, 0, 1024, 1024]] * 2, dtype=np.float32),
    }


def _set_contexts(unet: Any, inputs: dict[str, Any]) -> None:
    unet.set_timestep(inputs["timestep"])
    unet.set_clip_text_embedding(inputs["clip_text_embedding"])
    unet.set_pooled_text_embedding(inputs["pooled_text_embedding"])
    unet.set_time_ids(inputs["time_ids"])


def _jax_unet(unet: Any, inputs: dict[str, np.ndarray]) -> np.ndarray:
    """The JAX UNet under jit, its contexts set inside the traced function."""

    def run(unet: Any, args: dict[str, jax.Array]) -> jax.Array:
        _set_contexts(unet, args)
        return unet(args["x"])

    return nhwc_to_nchw(np.asarray(jax.jit(run)(unet, {k: jnp.asarray(v) for k, v in inputs.items()})))


def _port_unet(unet: SDXLUNet, inputs: dict[str, np.ndarray]) -> np.ndarray:
    args = {k: torch.tensor(v) for k, v in inputs.items()}
    _set_contexts(unet, args)
    with torch.no_grad():
        return unet(torch.tensor(nhwc_to_nchw(inputs["x"]))).numpy()


def _unet_pair() -> tuple[Any, SDXLUNet]:
    jax_manual_seed(0)
    jax_unet = JaxSDXLUNet(in_channels=4, base_channels=32)
    return jax_unet, _bridged(jax_unet, SDXLUNet(in_channels=4, base_channels=32))


def test_sdxl_unet_under_both_passes_matches_jax() -> None:
    """The reduced SDXL UNet (base_channels=32, the full topology) under both
    passes, as the int8 serving path applies them: 35 fused pairs, as in the
    full-width model, and every linear of at least 64 features quantized
    (at base 32 most are narrower than 256). The CPU quantizes
    deterministically on both sides, so the int8 weights are equal; the
    output is within 1e-4 of JAX's fused and quantized UNet on bridged
    weights. W8A16 here: W8A8 rounds every activation to int8, and a float32
    ulp of difference at a rounding boundary flips a value by a whole step,
    which the UNet's depth amplifies; W8A8 is held to JAX layer by layer
    (tests/test_torch_quant.py) and end to end on the card (PSNR)."""
    jax_unet, unet = _unet_pair()
    inputs = _unet_inputs()
    unfused = _port_unet(unet, inputs)
    n = jopt.quantize_linears(jax_unet, min_features=64, act_quant=False)
    assert n > 100 and opt.quantize_linears(unet, min_features=64, act_quant=False) == n
    assert jopt.fuse_group_norm_silu(jax_unet) == opt.fuse_group_norm_silu(unet) == 35
    jax_state = _state(jax_unet)
    assert set(unet.state_dict()) == set(jax_state)  # a module's buffers (scales) follow its parameters
    with pltpu.force_tpu_interpret_mode():
        want = _jax_unet(jax_unet, inputs)
    got = _port_unet(unet, inputs)
    assert got.shape == (2, 4, 16, 16)
    assert _rel(got, want) <= UNET_TOL
    assert 0 < _rel(got, unfused) < 0.05  # the int8 weights are a real, small change

    fused_state = {k: v.clone() for k, v in unet.state_dict().items()}
    assert opt.unfuse_group_norm_silu(unet) == 35
    np.testing.assert_allclose(_port_unet(unet, inputs), got, atol=MODULE_TOL)
    fresh = SDXLUNet(in_channels=4, base_channels=32)
    opt.quantize_linears(fresh, min_features=64, act_quant=False)
    opt.fuse_group_norm_silu(fresh)
    load_jax_state_dict(fresh, jax_state, strict=True)
    for key, value in fresh.state_dict().items():
        assert torch.equal(value, fused_state[key]), key


def test_every_quantized_linear_runs_once_per_unet_step() -> None:
    """The card's W8A8 launch gate (one row-mode launch per quantized linear
    call, 743 × 30 per SDXL request) rests on every quantized linear running
    exactly once per UNet forward; held at the reduced width, where 737
    linears of at least 64 features are quantized."""
    unet = SDXLUNet(in_channels=4, base_channels=32)
    n = opt.quantize_linears(unet, min_features=64, act_quant=False)
    calls: list[int] = []
    for layer in unet.layers(opt.QuantizedLinear, recurse=True):
        layer.register_forward_hook(lambda module, *_: calls.append(id(module)))
    _port_unet(unet, _unet_inputs())
    assert n == 737 and len(calls) == n and len(set(calls)) == n


def test_full_width_sdxl_unet_pass_counts() -> None:
    """The counts the card's int8 serving path checks, on the meta device."""
    unet = SDXLUNet(in_channels=4, device="meta")
    assert opt.fuse_group_norm_silu(unet) == 35
    assert opt.quantize_linears(unet, min_features=256) == 743
    assert sum(1 for _ in unet.layers(opt.QuantizedLinear, recurse=True)) == 743


# ---------------------------------------------------------------------------
# QKV projections
# ---------------------------------------------------------------------------


def _attn_pair() -> tuple[Any, Any]:
    jax_manual_seed(0)
    build = lambda p: p.Chain(p.SelfAttention(embedding_dim=32, num_heads=4), p.Linear(32, 8))  # noqa: E731
    jax_model = build(jfl)
    return jax_model, _bridged(jax_model, build(fl))


def test_fuse_qkv_projections_matches_jax_and_reverses() -> None:
    jax_model, model = _attn_pair()
    x = np.random.RandomState(0).randn(2, 6, 32).astype(np.float32)
    want = np.asarray(jax_model(jnp.asarray(x)))
    before_repr, before_keys = repr(model), list(model.state_dict())
    with torch.no_grad():
        base = model(torch.tensor(x)).numpy()
    np.testing.assert_allclose(base, want, atol=MODULE_TOL)

    assert jopt.fuse_qkv_projections(jax_model) == opt.fuse_qkv_projections(model) == 1
    fused = model.ensure_find(opt.FusedQKVProjection)
    assert fused.out_features == 96 and tuple(fused.weight.shape) == (96, 32)
    assert list(model.state_dict()) == list(jax_model.state_dict())
    with torch.no_grad():
        np.testing.assert_allclose(model(torch.tensor(x)).numpy(), np.asarray(jax_model(jnp.asarray(x))), atol=MODULE_TOL)
        np.testing.assert_allclose(model(torch.tensor(x)).numpy(), base, atol=MODULE_TOL)
    fresh = _attn_pair()[1]
    opt.fuse_qkv_projections(fresh)
    load_jax_state_dict(fresh, _state(jax_model), strict=True)
    assert torch.equal(fresh.ensure_find(opt.FusedQKVProjection).weight, fused.weight)

    assert opt.unfuse_qkv_projections(model) == 1
    assert model.find(opt.FusedQKVProjection) is None
    assert repr(model) == before_repr and list(model.state_dict()) == before_keys
    with torch.no_grad():
        np.testing.assert_array_equal(model(torch.tensor(x)).numpy(), base)  # exact weight round trip


def test_fuse_qkv_projections_skips_adapted_projections() -> None:
    """A projection that is not a plain Linear (an adapter's subclass) stays."""

    class AdaptedLinear(fl.Linear):
        pass

    _, model = _attn_pair()
    distribute = model.ensure_find(fl.SelfAttention).ensure_find(fl.Distribute)
    distribute.replace(distribute[0], AdaptedLinear(32, 32))
    assert opt.fuse_qkv_projections(model) == 0
