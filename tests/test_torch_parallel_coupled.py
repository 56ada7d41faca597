"""Row-coupled layers and late adapters on the port's mesh, on the CPU.

StyleAligned (each CFG half's first sample is every row's reference) and
reference-only control (the batch's first sample mixed with an unguided
pass) through `TextToImage(mesh=...)` with the CFG batch of four images
split over "data" at 2x1 (each rank one CFG half) and 4x1 (two rows a
rank: half the ranks without their half's reference), on the reduced SD1.5
of ``tests/test_torch_parallel.py`` (bridged weights, a stand-in text
encoder and VAE, one DDIM step at 128²); and SAG entered after the attentions were
split over "tensor" (1x2), which puts the attention it reads back whole.
One gloo group of 4 CPU ranks (``torch_mesh_group.py``) runs the port; the
JAX side runs here meanwhile, on its (4, 2) mesh of virtual devices. The
JAX `TextToImage` jits its loop with the model as an argument, which loses
these adapters' contexts (as with SAG, ROADMAP Queue 3), so its loop is
jitted as a closure over the model, as `_jax_sag_image` does.
"""

from __future__ import annotations

from pathlib import Path
from typing import Any

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import refiners_tpu.parallel as jpar
from refiners_tpu.foundationals.latent_diffusion import ReferenceOnlyControlAdapter as JaxReferenceOnlyControlAdapter
from refiners_tpu.foundationals.latent_diffusion import StyleAlignedAdapter as JaxStyleAlignedAdapter
from refiners_tpu_torch.conversion import nchw_to_nhwc, nhwc_to_nchw
from test_torch_parallel import _arrays, _jax_sd1, _jax_unet
from torch_mesh_group import COUPLED_IMAGES, COUPLED_SIZE, COUPLED_STEPS, STYLE_ALIGNED_SCALE, start_group

pytestmark = pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 virtual devices")

LEVEL = 1  # 8-bit levels: the envelope of test_self_attention_guidance_on_the_mesh_matches_jax
# relative Frobenius, the reduced UNet's prediction (test_torch_parallel.py's UNET_TOL): one DDIM step at
# this size moves the latents by under 0.1 %, so the images alone would not tell a wrong split apart
PREDICTION_TOL = 1e-4


def _jax_request(adapter: str, guide: np.ndarray) -> dict[str, Any]:
    """The JAX model's images with `adapter`, on its (4, 2) mesh, from the
    port's seed-42 noise (`TextToImage`'s draw), its loop jitted as a
    closure; and the first step's CFG-combined noise prediction (NCHW)."""
    from refiners_tpu.fluxion.utils import tensor_to_image

    sd = _jax_sd1(COUPLED_STEPS)
    if adapter == "style_aligned":
        JaxStyleAlignedAdapter(sd.unet, scale=STYLE_ALIGNED_SCALE).inject()
    else:
        JaxReferenceOnlyControlAdapter(sd.unet).inject().set_controlnet_condition(jnp.asarray(nchw_to_nhwc(guide)))
    jpar.shard_latent_diffusion(sd, jpar.make_mesh(data=4, tensor=2))
    h, w = COUPLED_SIZE
    noise = torch.randn((COUPLED_IMAGES, 4, h // 8, w // 8), generator=torch.Generator().manual_seed(42))
    x = sd.solver.scale_model_input(jnp.asarray(nchw_to_nhwc(noise.numpy())), step=-1)
    emb = jnp.repeat(sd.compute_clip_text_embedding("a photo of a cat", ""), COUPLED_IMAGES, axis=0)

    def diffuse(x: jax.Array, emb: jax.Array) -> tuple[jax.Array, jax.Array]:
        prediction = sd.predict_noise(x, 0, clip_text_embedding=emb, condition_scale=7.5)
        for step in sd.steps:
            x = sd(x, step=step, clip_text_embedding=emb, condition_scale=7.5)
        return sd.lda.decode(x), prediction

    images, prediction = jax.jit(diffuse)(x, emb)
    return {"images": [np.asarray(tensor_to_image((images[i : i + 1] + 1) / 2)) for i in range(COUPLED_IMAGES)],
            "prediction": nhwc_to_nchw(np.asarray(prediction))}  # fmt: skip


@pytest.fixture(scope="module")
def group(tmp_path_factory: pytest.TempPathFactory) -> tuple[dict[str, Any], dict[str, Any]]:
    """(rank 0's results of every port case, the JAX images by adapter)."""
    directory: Path = tmp_path_factory.mktemp("mesh_coupled")
    np.savez(directory / "unet.npz", **_arrays(_jax_unet()))
    h, w = COUPLED_SIZE
    guide = np.random.RandomState(5).randn(2 * COUPLED_IMAGES, 4, h // 8, w // 8).astype(np.float32)
    np.savez(directory / "coupled.npz", guide=guide)
    ranks = start_group(directory, "torch_mesh_group:coupled_cases")
    jax_side = {adapter: _jax_request(adapter, guide) for adapter in ("style_aligned", "reference_only")}
    return ranks.results(), jax_side


def _case(group: tuple[dict[str, Any], dict[str, Any]], name: str) -> Any:
    result = group[0][name]
    if isinstance(result, dict) and "error" in result:
        pytest.fail(f"case {name!r} raised on the ranks:\n{result['error']}")
    return result


def _levels(a: np.ndarray, b: np.ndarray) -> int:
    return int(np.abs(a.astype(np.int16) - b.astype(np.int16)).max())


def _rel(got: np.ndarray, want: np.ndarray) -> float:
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


@pytest.mark.parametrize("adapter", ["style_aligned", "reference_only"])
@pytest.mark.parametrize("mesh", ["2x1", "4x1"])
def test_row_coupled_adapter_on_a_data_split_matches_jax(
    group: tuple[dict[str, Any], dict[str, Any]], adapter: str, mesh: str
) -> None:
    """Each of the four images every rank returns is within 1 level of the
    JAX model's on its mesh and of the port's single-process one; the first
    step's noise prediction within `PREDICTION_TOL` of both, and the adapter
    moves it (against the bare model's) well past that."""
    got = _case(group, f"{adapter} {mesh}")
    on_mesh, single, want = got["mesh"], got["single"], group[1][adapter]
    assert len(on_mesh["images"]) == len(want["images"]) == len(single["images"]) == COUPLED_IMAGES
    for image, jax_image, single_image in zip(on_mesh["images"], want["images"], single["images"]):
        assert image.shape == (*COUPLED_SIZE, 3)
        assert _levels(image, jax_image) <= LEVEL and _levels(image, single_image) <= LEVEL
    assert on_mesh["prediction"].shape == want["prediction"].shape == (COUPLED_IMAGES, 4, 16, 16)
    assert _rel(on_mesh["prediction"], want["prediction"]) <= PREDICTION_TOL
    assert _rel(on_mesh["prediction"], single["prediction"]) <= PREDICTION_TOL
    assert _rel(single["prediction"], got["bare"]["prediction"]) > 100 * PREDICTION_TOL


def test_reference_only_under_a_tensor_split(group: tuple[dict[str, Any], dict[str, Any]]) -> None:
    """Reference-only control injected before a 1x2 placement: its guided
    self-attentions are structural copies that share the split attentions'
    scaled dot-product attention, whose head count is halved once. Within
    1 level and `PREDICTION_TOL` of the single-process request."""
    got = _case(group, "reference_only 1x2")
    for image, single in zip(got["mesh"]["images"], got["single"]["images"]):
        assert _levels(image, single) <= LEVEL
    assert _rel(got["mesh"]["prediction"], got["single"]["prediction"]) <= PREDICTION_TOL


def test_sag_entered_after_a_tensor_split_matches_sag_entered_before(
    group: tuple[dict[str, Any], dict[str, Any]],
) -> None:
    """SAG entered into the reduced SD1.5 after `TextToImage(mesh=1x2)` has
    split its attentions: the first step's check puts the middle-block
    attention SAG reads back whole (one warning, at the first request after
    SAG was entered), the others stay split, and at both requests the
    image is within 1 level, and the first step's prediction within
    `PREDICTION_TOL`, of SAG entered before the placement."""
    got = _case(group, "late sag 1x2")
    early = got["early"]
    assert len(got["late"]) == 2
    for late in got["late"]:
        assert _levels(late["images"][0], early["images"][0]) <= LEVEL
        assert _rel(late["prediction"], early["prediction"]) <= PREDICTION_TOL
    assert len(got["records"]) == 1 and "put back whole" in got["records"][0]
    assert len(got["whole"]) == 1 and "MiddleBlock" in got["whole"][0] and got["whole"][0] in got["records"][0]
    assert got["split"] > 0
