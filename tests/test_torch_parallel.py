"""The port's mesh layer against the JAX package's, on the CPU.

`refiners_tpu_torch.parallel` (`make_mesh`, the TP rules, `shard_module`,
`shard_latent_diffusion`) and `TextToImage(mesh=...)`, counterparts of
``tests/parallel/test_sharding.py``, ``test_sd_sharding.py`` and
``test_flash_sharded.py``. One gloo group of 4 CPU ranks (spawned once for
the file by ``torch_mesh_group.py``, a ``file://`` store under pytest's
tmp_path) runs every port case on weights bridged from the JAX models;
the JAX side runs here, meanwhile, on the 8 virtual CPU devices of
``tests/conftest.py`` (its packed flash kernel in interpret mode under
`force_flash`, as the JAX tests run it), on a ("data", "tensor") mesh of
(4, 2) where the JAX tests use one.
"""

from __future__ import annotations

from pathlib import Path
from typing import Any

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

import refiners_tpu.fluxion.layers as jfl
import refiners_tpu.parallel as jpar
from refiners_tpu.fluxion import manual_seed
from refiners_tpu.ops.attention import force_flash
from refiners_tpu_torch import parallel
from refiners_tpu_torch.conversion import nchw_to_nhwc, nhwc_to_nchw
from torch_mesh_group import SAG_SCALE, SAG_SIZE, SAG_STEPS, fake_text_embedding, start_group

pytestmark = pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 virtual devices")

# float32 on both sides, the same weights; the split changes the summation order only
BLOCK_TOL = 2e-5  # a CrossAttentionBlock2d (abs), as the JAX test holds its mesh run
ATTENTION_TOL = 1e-5  # one attention (abs), against JAX's packed kernel in interpret mode
UNET_TOL = 1e-4  # relative Frobenius, the reduced SD1UNet: depth amplifies summation-order noise
MESHES = [(2, 1), (1, 2), (2, 2), (4, 1)]


def _rel(got: np.ndarray, want: np.ndarray) -> float:
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _arrays(module: Any) -> dict[str, np.ndarray]:
    return {k: np.asarray(v) for k, v in module.state_dict().items()}


class _JaxFakeTextEncoder(jfl.Module):
    """The JAX side of `torch_mesh_group.FakeTextEncoder`."""

    def forward(self, texts: list[str]) -> jax.Array:
        return jnp.stack([jnp.asarray(fake_text_embedding(t)) for t in texts])


class _JaxFakeLDA(jfl.Module):
    """The JAX side of `torch_mesh_group.FakeLDA` (NHWC)."""

    def forward(self, z: jax.Array) -> jax.Array:
        return self.decode(z)

    def decode(self, z: jax.Array) -> jax.Array:
        img = jnp.tanh(z[..., :3])
        return jnp.repeat(jnp.repeat(img, 8, axis=1), 8, axis=2)


def _jax_unet() -> Any:
    from refiners_tpu.foundationals.latent_diffusion.stable_diffusion_1.unet import SD1UNet

    manual_seed(0)
    return SD1UNet(in_channels=4, base_channels=32)


def _jax_sd1(steps: int = 3) -> Any:
    from refiners_tpu.foundationals.latent_diffusion import DDIM
    from refiners_tpu.foundationals.latent_diffusion.stable_diffusion_1 import StableDiffusion_1

    return StableDiffusion_1(
        unet=_jax_unet(), lda=_JaxFakeLDA(), clip_text_encoder=_JaxFakeTextEncoder(),
        solver=DDIM(num_inference_steps=steps),
    )  # fmt: skip


def _jax_text_to_image(num_images: int) -> list[np.ndarray]:
    """The JAX mesh pipeline's images (`TextToImage(mesh=...)`: its placement,
    its jitted diffuse and decode) on the noise the port draws from seed 42."""
    from refiners_tpu.fluxion.utils import tensor_to_image
    from refiners_tpu.pipelines import TextToImage

    pipe = TextToImage(_jax_sd1(), size=(64, 64), mesh=jpar.make_mesh(data=4, tensor=2), num_images=num_images)
    pipe._ensure_sharded()
    noise = torch.randn((num_images, 4, 8, 8), generator=torch.Generator().manual_seed(42))
    x = pipe.sd.solver.scale_model_input(jnp.asarray(nchw_to_nhwc(noise.numpy())), step=-1)
    emb = jnp.repeat(pipe.sd.compute_clip_text_embedding("a photo of a cat", ""), num_images, axis=0)
    x, emb = pipe._place(x, emb)
    z = pipe._diffuse_fn()(pipe.sd, x, emb, 7.5, jax.random.key(0))
    image = pipe._decode_fn()(pipe.sd.lda, z)
    return [np.asarray(tensor_to_image((image[i : i + 1] + 1) / 2)) for i in range(num_images)]


def _jax_sag_image() -> np.ndarray:
    """The JAX model's image with self-attention guidance, on its (4, 2) mesh,
    for `SAG_STEPS` DDIM steps at `SAG_SIZE` from the port's seed-42 noise.
    Its denoising loop is jitted as a closure over the model: the JAX
    pipeline's jit takes the model as an argument and its SAG adapter's
    context is lost there ("Context self_attention_map not found")."""
    from refiners_tpu.fluxion.utils import tensor_to_image

    sd = _jax_sd1(SAG_STEPS)
    sd.set_self_attention_guidance(True, scale=SAG_SCALE)
    jpar.shard_latent_diffusion(sd, jpar.make_mesh(data=4, tensor=2))
    h, w = SAG_SIZE
    noise = torch.randn((1, 4, h // 8, w // 8), generator=torch.Generator().manual_seed(42))
    x = sd.solver.scale_model_input(jnp.asarray(nchw_to_nhwc(noise.numpy())), step=-1)
    emb = sd.compute_clip_text_embedding("a photo of a cat", "")

    def diffuse(x: jax.Array, emb: jax.Array) -> jax.Array:
        for step in sd.steps:
            x = sd(x, step=step, clip_text_embedding=emb, condition_scale=7.5)
        return sd.lda.decode(x)

    return np.asarray(tensor_to_image((jax.jit(diffuse)(x, emb) + 1) / 2))


@pytest.fixture(scope="module")
def group(tmp_path_factory: pytest.TempPathFactory) -> tuple[dict[str, Any], dict[str, Any]]:
    """(rank 0's results of every port case, the JAX side's)."""
    from refiners_tpu.foundationals.latent_diffusion.cross_attention import CrossAttentionBlock2d

    directory: Path = tmp_path_factory.mktemp("mesh")
    rs = np.random.RandomState(0)
    manual_seed(0)
    block = CrossAttentionBlock2d(
        channels=64, context_embedding_dim=96, context_key="clip_text_embedding", num_attention_heads=4,
        use_linear_projection=True,
    )  # fmt: skip
    manual_seed(2)
    block10 = CrossAttentionBlock2d(  # SDXL's 640-channel stage has 10 heads: 4 ranks do not divide them
        channels=160, context_embedding_dim=96, context_key="clip_text_embedding", num_attention_heads=10,
        use_linear_projection=True,
    )  # fmt: skip
    manual_seed(1)
    # in a chain, as in a model: the rules match the output projection by its parent's name
    attn8 = jfl.Chain(jfl.SelfAttention(embedding_dim=512, num_heads=8))
    attn1 = jfl.Chain(jfl.SelfAttention(embedding_dim=64, num_heads=1))
    unet = _jax_unet()
    inputs = {
        "block_x": rs.randn(2, 8, 8, 64).astype(np.float32), "block_text": rs.randn(2, 7, 96).astype(np.float32),
        "block10_x": rs.randn(2, 8, 8, 160).astype(np.float32),
        "attn8": rs.randn(4, 256, 512).astype(np.float32), "attn1": rs.randn(4, 256, 64).astype(np.float32),
        "unet_x": rs.randn(4, 16, 16, 4).astype(np.float32), "unet_text": rs.randn(4, 7, 768).astype(np.float32),
    }  # fmt: skip
    for name, module in (("block", block), ("block10", block10), ("attn8", attn8), ("attn1", attn1), ("unet", unet)):
        np.savez(directory / f"{name}.npz", **_arrays(module))
    port_inputs = {k: nhwc_to_nchw(v) if k in ("block_x", "block10_x", "unet_x") else v for k, v in inputs.items()}
    np.savez(directory / "inputs.npz", **port_inputs)
    ranks = start_group(directory, "torch_mesh_group:parallel_cases")

    # the JAX side, while the ranks run
    mesh = jpar.make_mesh(data=2, tensor=4)

    def run_block(m: Any, v: jax.Array, t: jax.Array) -> jax.Array:
        m.set_context("cross_attention_block", {"clip_text_embedding": t})
        return m(v)

    jax_side: dict[str, Any] = {}
    for name, module in (("block", block), ("block10", block10)):
        jpar.shard_module(module, mesh, jpar.ATTENTION_TP_RULES)
        x = jax.device_put(jnp.asarray(inputs[f"{name}_x"]), jpar.data_sharding(mesh, 4))
        jax_side[name] = nhwc_to_nchw(np.asarray(jax.jit(run_block)(module, x, jnp.asarray(inputs["block_text"]))))
    mesh = jpar.make_mesh(data=4, tensor=2)
    for name, attention in (("attn8", attn8), ("attn1", attn1)):
        jpar.shard_module(attention, mesh, jpar.ATTENTION_TP_RULES)
        x = jax.device_put(jnp.asarray(inputs[name]), NamedSharding(mesh, P("data")))
        with force_flash():
            jax_side[name] = np.asarray(jax.jit(lambda m, v: m(v))(attention, x))

    def run_unet(m: Any, v: jax.Array, t: jax.Array) -> jax.Array:
        m.set_timestep(jnp.asarray([500]))
        m.set_clip_text_embedding(t)
        return m(v)

    out = jax.jit(run_unet)(unet, jnp.asarray(inputs["unet_x"]), jnp.asarray(inputs["unet_text"]))
    jax_side["unet"] = nhwc_to_nchw(np.asarray(out))
    jpar.shard_module(unet, mesh, jpar.ATTENTION_TP_RULES)
    jax_side["unet_split"] = sum(1 for _, a in unet.arrays() if "tensor" in str(getattr(a.sharding, "spec", "")))
    jax_side["jax_unet_arrays"] = {
        path: jpar.infer_partition_spec(path, a, jpar.ATTENTION_TP_RULES) for path, a in unet.arrays()
    }
    for n in (1, 4):
        jax_side[f"text_to_image {n}"] = _jax_text_to_image(n)
    jax_side["sag"] = _jax_sag_image()
    jax_side["timesteps"] = np.asarray(_jax_sd1().solver.timesteps)
    return ranks.results(), jax_side


def _case(group: tuple[dict[str, Any], dict[str, Any]], name: str) -> Any:
    result = group[0][name]
    if isinstance(result, dict) and "error" in result:
        pytest.fail(f"case {name!r} raised on the ranks:\n{result['error']}")
    return result


# -- make_mesh ---------------------------------------------------------------------------------


def test_make_mesh_shapes_and_asserts(group: tuple[dict[str, Any], dict[str, Any]]) -> None:
    """`make_mesh` over the 4 ranks, as `refiners_tpu.parallel.make_mesh`
    over 4 devices: the shapes, the axis names and the same assertion
    messages; a sub-mesh of ranks 0-1 (rank 0 at (0, 0)); cuda by default."""
    got = _case(group, "mesh")
    devices = jax.devices()[:4]
    for args in ({"tensor": 2}, {}, {"data": 4}, {"data": 1, "tensor": 4}):
        want = jpar.make_mesh(devices=devices, **args)
        shape, names, coordinate = got[repr(args)]
        assert (shape, names, coordinate) == (want.devices.shape, want.axis_names, (0, 0)), args
    assert got["sub"] == ((2, 1), (0, 0))
    for args in ({"data": 3}, {"tensor": 3}, {"data": 2, "tensor": 1}):
        with pytest.raises(AssertionError) as jax_error:
            jpar.make_mesh(devices=devices, **args)
        assert got[f"raises {args}"] == str(jax_error.value), args
    assert "CUDA" in got["cuda"]


def test_make_mesh_needs_a_process_group() -> None:
    """No silent world of 1: without a process group `make_mesh` raises."""
    assert not torch.distributed.is_initialized()
    with pytest.raises(RuntimeError, match="process group"):
        parallel.make_mesh(device_type="cpu")


# -- the rules ---------------------------------------------------------------------------------


def test_rules_are_the_jax_rules_transposed() -> None:
    """Each rule has the JAX rule's pattern and its spec in the port's layout:
    a Linear weight's (in, out) spec reversed, so JAX's P(None, "tensor")
    (split outputs) is ("tensor", None), placed as `Shard(0)`, and
    P("tensor", None) is (None, "tensor"), `Shard(1)`; biases keep theirs."""
    from torch.distributed.tensor import Replicate, Shard

    from refiners_tpu_torch.parallel.sharding import placement

    assert len(parallel.ATTENTION_TP_RULES) == len(jpar.ATTENTION_TP_RULES)
    for port_rule, jax_rule in zip(parallel.ATTENTION_TP_RULES, jpar.ATTENTION_TP_RULES):
        assert port_rule.pattern == jax_rule.pattern
        assert port_rule.spec == tuple(reversed(tuple(jax_rule.spec))), port_rule.pattern
    for path, shape, want in (
        ("Distribute.Linear_2.weight", (8, 4), Shard(0)),  # JAX: P(None, "tensor") on (4, 8)
        ("SelfAttention.Linear.weight", (8, 4), Shard(1)),  # JAX: P("tensor", None)
        ("Distribute.Linear.bias", (8,), Shard(0)),
        ("Conv2d.weight", (8, 4, 3, 3), Replicate()),
    ):
        assert placement(parallel.infer_partition_spec(path, torch.empty(shape), parallel.ATTENTION_TP_RULES)) == want


def test_rules_match_the_same_unet_paths(group: tuple[dict[str, Any], dict[str, Any]]) -> None:
    """On the reduced SD1UNet's state-dict paths (the same in both packages),
    the port infers for every tensor the JAX spec in the port's layout."""
    from refiners_tpu_torch.foundationals.latent_diffusion import SD1UNet

    jax_specs = group[1]["jax_unet_arrays"]
    port = dict(SD1UNet(in_channels=4, base_channels=32, device="meta").named_parameters())
    assert sorted(port) == sorted(jax_specs)
    for path, jax_spec in jax_specs.items():
        got = parallel.infer_partition_spec(path, port[path], parallel.ATTENTION_TP_RULES)
        assert got == tuple(reversed(tuple(jax_spec))), path
    assert sum(1 for spec in jax_specs.values() if "tensor" in spec) >= 48


# -- tensor parallelism on blocks and attention --------------------------------------------------


@pytest.mark.parametrize("mesh", ["2x2", "1x4"])
def test_cross_attention_block_tp_matches_jax(group: tuple[dict[str, Any], dict[str, Any]], mesh: str) -> None:
    """A CrossAttentionBlock2d (64 channels, 4 heads, linear projections)
    split by the TP rules at (data, tensor) = (2, 2) and (1, 4), against
    the JAX block on its (2, 4) mesh; the Q/K/V weights split on their
    output features (`Shard(0)`, local (64/t, in)), the output projections
    on their inputs (`Shard(1)`), the GeGLU's first Linear on its outputs."""
    got = _case(group, f"block {mesh}")
    np.testing.assert_allclose(got["out"], group[1]["block"], atol=BLOCK_TOL)
    t = int(mesh.split("x")[1])
    layout = got["layout"]
    prefix = "Chain_2.CrossAttentionBlock.Residual_1.SelfAttention."
    assert layout[prefix + "Distribute.Linear_1.weight"] == ("Shard(0)", (64 // t, 64))
    assert layout[prefix + "Distribute.Linear_1.bias"] == ("Shard(0)", (64 // t,))
    assert layout[prefix + "Linear.weight"] == ("Shard(1)", (64, 64 // t))
    assert layout[prefix + "Linear.bias"] == ("Replicate", (64,))
    assert layout["Chain_2.CrossAttentionBlock.Residual_3.Linear_1.weight"] == ("Shard(0)", (512 // t, 64))
    assert layout["Chain_2.CrossAttentionBlock.Residual_3.Linear_2.weight"] == ("Shard(1)", (64, 256 // t))
    assert layout["Chain_1.Linear.weight"] == ("replicated", (64, 64))


def test_indivisible_heads_keep_their_attention_whole(group: tuple[dict[str, Any], dict[str, Any]]) -> None:
    """SDXL's case: 10 heads (its 640-channel stage) under tensor = 4. The
    attentions' weights stay whole (each rank runs all 10 heads), the
    GeGLU's Linears still split (1280 and 640 features divide by 4); against
    the JAX block on its (2, 4) mesh, where the kernel's partitioning rule
    replicates the heads."""
    got = _case(group, "block 10 heads 1x4")
    np.testing.assert_allclose(got["out"], group[1]["block10"], atol=BLOCK_TOL)
    layout = got["layout"]
    attention = [k for k in layout if ".Residual_1." in k or ".Residual_2." in k]
    assert attention and {layout[k][0] for k in attention} == {"replicated"}
    assert layout["Chain_2.CrossAttentionBlock.Residual_3.Linear_1.weight"] == ("Shard(0)", (320, 160))
    assert layout["Chain_2.CrossAttentionBlock.Residual_3.Linear_2.weight"] == ("Shard(1)", (160, 160))


@pytest.mark.parametrize("name", ["attention 8 heads", "attention 1 head"])
def test_attention_on_local_heads_and_rows(group: tuple[dict[str, Any], dict[str, Any]], name: str) -> None:
    """A self-attention at 256 tokens on the (2, 2) mesh: each rank runs its
    batch rows and its heads (8 heads of d = 64: 4 a rank), no collective
    inside the attention; one head of d = 64 does not split over 2 ranks, so
    its weights stay whole and each rank runs the head on its rows. Against
    the JAX module on its (4, 2) mesh through the packed flash kernel."""
    got = _case(group, name)
    key = "attn8" if "8" in name else "attn1"
    np.testing.assert_allclose(got["out"], group[1][key], atol=ATTENTION_TOL)
    placements = {place for place, _ in got["layout"].values()}
    if key == "attn8":
        assert got["local_heads"] == 4 and "Shard(0)" in placements
    else:
        assert got["local_heads"] == 1 and placements == {"replicated"}


@pytest.mark.parametrize("mesh", [f"{d}x{t}" for d, t in MESHES])
def test_sd1_unet_forward_on_the_mesh_matches_jax(group: tuple[dict[str, Any], dict[str, Any]], mesh: str) -> None:
    """The reduced SD1UNet (base_channels=32, bridged weights) at batch 4 on
    each (data, tensor) mesh (the 2-rank meshes on ranks 0-1), against the
    JAX UNet; at tensor 2 the rules split as many tensors as JAX's."""
    got = _case(group, f"unet {mesh}")
    assert _rel(got["out"], group[1]["unet"]) <= UNET_TOL
    if mesh.endswith("x2"):
        assert got["split"] == group[1]["unet_split"] >= 48
    else:
        assert got["split"] == 0


def test_shard_latent_diffusion_replicates_non_unet_parts(group: tuple[dict[str, Any], dict[str, Any]]) -> None:
    """The UNet's attention and feed-forward Linears split over "tensor"; the
    VAE (each rank's its own before: rank 0's on every rank after), the text
    encoder and the solver replicated; the model keeps the mesh."""
    got = _case(group, "placement")
    split = [k for k, (place, _) in got["unet"].items() if place.startswith("Shard")]
    assert len(split) == group[1]["unet_split"] >= 48
    assert {place for place, _ in got["lda"].values()} == {"replicated"}
    assert got["lda_equal_across_ranks"] and got["mesh_kept"]
    assert got["timesteps"].tolist() == group[1]["timesteps"].tolist()


@pytest.mark.parametrize("num_images", [1, 4])
def test_text_to_image_on_the_mesh_matches_jax(group: tuple[dict[str, Any], dict[str, Any]], num_images: int) -> None:
    """`TextToImage(mesh=make_mesh(data=2, tensor=2))` on the reduced SD1.5
    (3 DDIM steps, 64², a stand-in text encoder and VAE): the CFG pair (and
    the 4 images' CFG batch of 8) split over "data", the weights over
    "tensor"; every rank returns every image, each within 1 level of the JAX
    mesh pipeline's on the same noise and of the port's single-process run.
    Without a seed, every rank draws rank 0's (their own streams differ)."""
    got = _case(group, f"text_to_image {num_images}")
    assert got["sharded"] and got["unseeded_equal"]
    want = group[1][f"text_to_image {num_images}"]
    assert len(got["images"]) == len(want) == len(got["single"]) == num_images
    for image, jax_image, single in zip(got["images"], want, got["single"]):
        assert image.shape == (64, 64, 3)
        assert np.abs(image.astype(np.int16) - jax_image.astype(np.int16)).max() <= 1
        assert np.abs(image.astype(np.int16) - single.astype(np.int16)).max() <= 1


@pytest.mark.parametrize("mesh", ["2x1", "2x2"])
def test_self_attention_guidance_on_the_mesh_matches_jax(
    group: tuple[dict[str, Any], dict[str, Any]], mesh: str
) -> None:
    """SAG (scale 0.75, one DDIM step at 128²: the reduced UNet's middle
    block at 2², where its mask is not trivial) through
    `TextToImage(mesh=...)` with the CFG pair split over "data" (on ranks
    0-1 at 2x1): its attention map is gathered, and read whole on every
    rank, as GSPMD gives it to the JAX model. Injected before the
    placement, the middle attention that SAG reads stays whole at tensor 2
    while the others split. Within 1 level of the JAX model's image on its
    mesh (`_jax_sag_image`) and of the port's single-process one."""
    got = _case(group, f"sag {mesh}")
    for want in (group[1]["sag"], got["single"]):
        assert np.abs(got["image"].astype(np.int16) - want.astype(np.int16)).max() <= 1
    assert not got["middle_attention_split"]
    assert (got["split"] > 0) == mesh.endswith("x2")


@pytest.mark.parametrize("mesh", ["4x1", "2x2"])
def test_run_unet_splits_and_gathers_batch_shaped_contexts(
    group: tuple[dict[str, Any], dict[str, Any]], mesh: str
) -> None:
    """`parallel.inference.run_unet` on a stand-in UNet whose inner chains
    add a context tensor of the batch's rows and one of one row, then
    record their output where SAG records its map. The context dict was
    replaced, last by one without the batch's tensor (as SDXL's UNet sets
    its "diffusion" context key by key), so only the inner chains' own
    copies hold it: each rank's rows meet their own rows of it there (the
    result equals the whole batch's); the copies hold the whole tensor
    again after the call; the one-row tensor is not split; the recorded
    output is gathered whole."""
    got = _case(group, f"contexts {mesh}")
    np.testing.assert_array_equal(got["out"], got["want"])
    np.testing.assert_array_equal(got["recorded"], got["want"])
    assert got["root_lacks_bias"] and got["bias_restored"] and got["shift_kept"]


def test_the_mesh_refuses_what_it_would_compute_wrongly(group: tuple[dict[str, Any], dict[str, Any]]) -> None:
    """A layer that reads other rows of its batch than its own (a stand-in
    that flips the batch, ``reads_other_rows = True``) and that the mesh does
    not hand its rows (not one of `parallel.inference._rows_coupled`) raises
    under a "data" split; with data = 1, or a batch that "data" does not
    divide, it runs whole. StyleAligned, reference-only control and an
    adapter entered after a "tensor" split run on the mesh now
    (`tests/test_torch_parallel_coupled.py`)."""
    got = _case(group, "refusals")
    assert "ReadsOtherRows reads other rows" in got["split"]
    np.testing.assert_array_equal(got["whole"], got["want"])
    np.testing.assert_array_equal(got["indivisible"], got["want"][2:])
