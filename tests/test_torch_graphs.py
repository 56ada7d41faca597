"""The port's compiled programs (`refiners_tpu_torch.fluxion.graphs`) against
the JAX package's jit, on the CPU.

- the program key of `TextToImage`'s loop changes exactly when the JAX
  package's jitted loop (`TextToImage._diffuse_fn()`) compiles again, edit
  by edit, on a reduced SD1.5 (`SD1UNet(base_channels=32)`, 1-step DDIM,
  64²); and the one documented difference (a parameter given new storage);
- what a call brings is bound, not keyed: its tensors (aliasing kept), the
  contexts' and the attributes' tensors; the contexts are put back after a
  call, and after `Program.eager`; a key change is named by its first
  token; a pipeline's two programs share one memory pool;
- the programs read nothing back to the host (what a capture cannot hold),
  for the loop under every solver and adapter that `chip_smoke.py` serves,
  and for the SD1.5 training example's step;
- `training.jit_step`: the port's Trainer (eager on the CPU) against the JAX
  Trainer under ``jit_step = True``, step by step on
  `tests/training_utils/mock_config.toml`;
- a gloo mesh runs the programs eagerly.

The CUDA graphs themselves (capture, replay, launch counts, generators) are
held on the card: `tests/test_torch_graphs_kernel.py`.
"""

from __future__ import annotations

import traceback
from typing import Any

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.overrides import TorchFunctionMode

import refiners_tpu.training_utils as jtu
import refiners_tpu_torch.fluxion.layers as fl
import refiners_tpu_torch.training_utils as tu
from refiners_tpu.fluxion import manual_seed as jax_manual_seed
from refiners_tpu.foundationals.clip import CLIPTextEncoder as JaxCLIPTextEncoder
from refiners_tpu.foundationals.latent_diffusion import DDIM as JaxDDIM
from refiners_tpu.foundationals.latent_diffusion import SD1UNet as JaxSD1UNet
from refiners_tpu.foundationals.latent_diffusion import StableDiffusion_1 as JaxStableDiffusion_1
from refiners_tpu.foundationals.latent_diffusion.lora import SDLoraManager as JaxSDLoraManager
from refiners_tpu.foundationals.latent_diffusion.stable_diffusion_1 import SD1Autoencoder as JaxSD1Autoencoder
from refiners_tpu.pipelines import TextToImage as JaxTextToImage
from refiners_tpu_torch.conversion import load_jax_state_dict
from refiners_tpu_torch.fluxion import graphs
from refiners_tpu_torch.foundationals.clip import CLIPImageEncoder, CLIPTextEncoder
from refiners_tpu_torch.foundationals.latent_diffusion import (
    DDIM,
    DPMSolver,
    Euler,
    LCMSolver,
    ReferenceOnlyControlAdapter,
    SD1Autoencoder,
    SD1ControlnetAdapter,
    SD1ELLAAdapter,
    SD1IPAdapter,
    SD1T2IAdapter,
    SD1UNet,
    SDFreeUAdapter,
    StableDiffusion_1,
    StyleAlignedAdapter,
)
from refiners_tpu_torch.foundationals.latent_diffusion.cross_attention import CrossAttentionBlock
from refiners_tpu_torch.foundationals.latent_diffusion.lora import SDLoraManager
from refiners_tpu_torch.foundationals.latent_diffusion.restart import Restart
from refiners_tpu_torch.foundationals.latent_diffusion.solvers import SolverParams
from refiners_tpu_torch.foundationals.latent_diffusion.t2i_adapter import ConditionEncoder as T2IConditionEncoder
from refiners_tpu_torch.pipelines import TextToImage, _diffuse
from tests.test_torch_training import (
    MOCK_TOML,
    TRAINER_TOL,
    JaxMockConfig,
    JaxMockTrainer,
    PortMockConfig,
    PortMockTrainer,
    _configure,
    _rel,
)

LATENT = 8  # 64² images


@pytest.fixture(autouse=True, scope="module")
def _torch_threads() -> Any:
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _port_sd1(steps: int = 1) -> StableDiffusion_1:
    return StableDiffusion_1(
        unet=SD1UNet(in_channels=4, base_channels=32),
        lda=SD1Autoencoder(),
        clip_text_encoder=CLIPTextEncoder(embedding_dim=768, num_layers=2, num_attention_heads=12),
        solver=DDIM(num_inference_steps=steps),
        device="cpu",
    )


def _lora_weights(linears: list[Any], seed: int) -> dict[str, np.ndarray]:
    """A rank-8 LoRA in the reference key layout on `linears` (in the order
    both packages' managers attach them)."""
    rs = np.random.RandomState(seed)
    weights: dict[str, np.ndarray] = {}
    for n, linear in enumerate(linears):
        weights[f"lora_unet_{n:04d}.lora_down.weight"] = (rs.randn(8, linear.in_features) * 0.05).astype(np.float32)
        weights[f"lora_unet_{n:04d}.lora_up.weight"] = (rs.randn(linear.out_features, 8) * 0.05).astype(np.float32)
    return weights


@pytest.fixture(scope="module")
def pair() -> dict[str, Any]:
    """The JAX package's reduced SD1.5 with its jitted loop, and the port's
    (the weights need not agree: only the keys are compared)."""
    jax_manual_seed(0)
    jax_sd = JaxStableDiffusion_1(
        unet=JaxSD1UNet(in_channels=4, base_channels=32),
        lda=JaxSD1Autoencoder(),
        clip_text_encoder=JaxCLIPTextEncoder(embedding_dim=768, num_layers=2, num_attention_heads=12),
        solver=JaxDDIM(num_inference_steps=1),
    )
    sd = _port_sd1()
    linears = [l for b in sd.unet.layers(CrossAttentionBlock, recurse=True) for l in b.layers(fl.Linear, recurse=True)]
    return {
        "jax_sd": jax_sd,
        "jitted": JaxTextToImage(jax_sd, size=(64, 64))._diffuse_fn(),
        "sd": sd,
        "program": graphs.Program(_diffuse),
        "generator": torch.Generator().manual_seed(0),
        "lora": _lora_weights(linears, seed=3),
    }


class _Keys:
    """Both packages' side of one request: JAX's jitted loop called (its
    cache counted), the port's program key looked up."""

    def __init__(self, pair: dict[str, Any]) -> None:
        self.pair = pair
        self.seen: set[Any] = set()

    def request(self, num_images: int = 1, size: tuple[int, int] = (LATENT, LATENT), scale: float = 7.5) -> tuple[bool, bool]:
        """(JAX compiled again, the port's key is new)."""
        p, (h, w) = self.pair, size
        jitted = p["jitted"]
        before = jitted._cache_size()
        x, emb = jnp.zeros((num_images, h, w, 4)), jnp.zeros((2 * num_images, 77, 768))
        jitted(p["jax_sd"], x, emb, scale, jax.random.key(0)).block_until_ready()
        key = p["program"].key(p["sd"], torch.zeros(num_images, 4, h, w), torch.zeros(2 * num_images, 77, 768), scale, p["generator"])
        new = key not in self.seen
        self.seen.add(key)
        return jitted._cache_size() > before, new


def test_the_program_key_changes_when_jax_compiles_again(pair: dict[str, Any]) -> None:
    """Each edit below, one after the other: the port's key
    is new exactly when JAX's jitted loop grows its cache. A ControlNet's
    condition lives in a context, which the JAX package leaves out of its
    pytree (its jitted loop cannot see one set outside, so its key cannot
    change) and which the port binds as an input (same shape, same key)."""
    keys, sd, jax_sd = _Keys(pair), pair["sd"], pair["jax_sd"]
    steps: list[tuple[str, tuple[bool, bool]]] = [("first request", keys.request()), ("again", keys.request())]

    weights = pair["lora"]
    JaxSDLoraManager(jax_sd).add_loras("style", {k: jnp.asarray(v) for k, v in weights.items()}, scale=0.8,
                                       unet_inclusions=["CrossAttentionBlock"])  # fmt: skip
    manager = SDLoraManager(sd)
    manager.add_loras("style", {k: torch.tensor(v) for k, v in weights.items()}, scale=0.8,
                      unet_inclusions=["CrossAttentionBlock"])  # fmt: skip
    steps.append(("LoRA injected", keys.request()))
    JaxSDLoraManager(jax_sd).set_scale("style", 0.5)
    manager.set_scale("style", 0.5)
    steps.append(("its scale changed", keys.request()))
    JaxSDLoraManager(jax_sd).remove_loras("style")
    manager.remove_loras("style")
    steps.append(("LoRA ejected", keys.request()))

    steps.append(("condition_scale", keys.request(scale=5.0)))
    steps.append(("size", keys.request(size=(LATENT, 2 * LATENT))))
    steps.append(("num_images", keys.request(num_images=2)))

    sd.unet.load_state_dict({k: v.clone() for k, v in sd.unet.state_dict().items()})
    jax_sd.unet.load_state_dict({k: v + 0 for k, v in jax_sd.unet.state_dict().items()})
    steps.append(("load_state_dict in place", keys.request()))

    # a context tensor of the same shape: JAX's key is its pytree's, which leaves the provider out
    controlnet = SD1ControlnetAdapter(sd.unet, name="canny").inject()
    controlnet.set_controlnet_condition(torch.rand(1, 3, 8 * LATENT, 8 * LATENT))
    keys.request()  # the port's key with the adapter (JAX: not injected, a cache hit)
    treedef = jax.tree_util.tree_structure(jax_sd)
    jax_sd.unet.set_context("controlnet", {"condition_canny": jnp.ones((1, 8 * LATENT, 8 * LATENT, 3))})
    assert jax.tree_util.tree_structure(jax_sd) == treedef
    controlnet.set_controlnet_condition(torch.rand(1, 3, 8 * LATENT, 8 * LATENT))
    steps.append(("a new ControlNet condition of the same shape", keys.request()))
    controlnet.eject()

    sd.set_inference_steps(2)
    jax_sd.set_inference_steps(2)
    steps.append(("the step count", keys.request()))

    mismatched = [(name, jax_new, port_new) for name, (jax_new, port_new) in steps if jax_new != port_new]
    assert not mismatched, mismatched
    assert [name for name, (jax_new, _) in steps if jax_new] == [
        "first request", "LoRA injected", "its scale changed", "condition_scale", "size", "num_images", "the step count",
    ]  # fmt: skip


def test_where_the_program_key_differs_from_jax(pair: dict[str, Any]) -> None:
    """The documented differences. A replay reads its capture's addresses,
    so new storage (here an assigned `Parameter`) is a new program in the
    port, where JAX passes arrays as arguments and keeps its compiled loop.
    The contexts are inputs of the port's programs (their tensors' shapes
    in the key) and are not in JAX's pytree: the condition an ejected
    ControlNet leaves in them makes a new program in the port only."""
    keys, sd, jax_sd = _Keys(pair), pair["sd"], pair["jax_sd"]
    keys.request()
    conv = next(sd.unet.layers(fl.Conv2d, recurse=True))
    conv.weight = torch.nn.Parameter(conv.weight.detach().clone())
    jax_sd.unet.load_state_dict({k: v * 1.0 for k, v in jax_sd.unet.state_dict().items()})
    assert keys.request() == (False, True)
    controlnet = SD1ControlnetAdapter(sd.unet, name="depth").inject()
    controlnet.set_controlnet_condition(torch.rand(1, 3, 8 * LATENT, 8 * LATENT))
    controlnet.eject()
    assert "condition_depth" in sd.unet.provider.contexts["controlnet"]
    assert keys.request() == (False, True)


# -- what a call brings ----------------------------------------------------------------


class _Scaled(fl.Chain):
    """x · context["scale"]["factor"] + offset, the offset a plain attribute."""

    def __init__(self) -> None:
        super().__init__(fl.Linear(4, 4), fl.Lambda(self._scale))
        self.offset = torch.zeros(4)

    def init_context(self) -> dict[str, dict[str, Any]]:
        return {"scale": {"factor": None, "seen": []}}

    def _scale(self, x: torch.Tensor) -> torch.Tensor:
        context = self.use_context("scale")
        context["seen"].append(x)  # written in place by each run
        return x * context["factor"] + self.offset


def test_a_call_binds_its_tensors_and_puts_the_contexts_back() -> None:
    """The call's tensors (arguments, a context's, a plain attribute's) are
    what the program reads and are not in the key; two arguments that are
    one tensor are one input (and a different program from two tensors);
    after a call the contexts hold what they held before it (a run's writes
    into their lists included), as a jitted JAX function leaves them."""
    chain = _Scaled()
    chain.set_context("scale", {"factor": torch.full((4,), 2.0), "seen": []})
    program = graphs.Program(lambda m, x, y: m(x) + y)
    x = torch.randn(3, 4)
    key = program.key(chain, x, x)
    walk = graphs._Walk([chain, x, x], {})
    bound = {id(x), id(chain.offset), id(chain.provider.contexts["scale"]["factor"])}
    assert len(walk.tensors) == 3 and {id(t) for t in walk.tensors} == bound
    assert program.key(chain, x, x.clone()) != key  # aliasing is part of the program
    chain.set_context("scale", {"factor": torch.full((4,), 3.0), "seen": []})
    chain.offset = torch.ones(4)
    assert program.key(chain, torch.randn(3, 4).add_(1), torch.randn(3, 4)) != key
    y = torch.randn(3, 4)
    assert program.key(chain, y, y) == key  # new values, same shapes: the same program
    out = program(chain, y, y)
    torch.testing.assert_close(out, chain[0](y) * 3.0 + 1.0 + y, rtol=0, atol=0)
    assert chain.provider.contexts["scale"]["seen"] == [] and program.key(chain, y, y) == key
    chain.offset = torch.ones(5)
    assert program.key(chain, y, y) != key  # a bound tensor's shape is in the key


def test_eager_runs_the_function_and_puts_the_contexts_back() -> None:
    """`Program.eager` runs the function as a first call runs it, on any
    device: the result of the function, the contexts put back, no capture."""
    chain = _Scaled()
    chain.set_context("scale", {"factor": torch.full((4,), 2.0), "seen": []})
    program = graphs.Program(lambda m, x: m(x))
    x = torch.randn(3, 4)
    out = program.eager(chain, x)
    torch.testing.assert_close(out, chain[0](x) * 2.0 + chain.offset, rtol=0, atol=0)
    assert chain.provider.contexts["scale"]["seen"] == [] and program.captures == 0


def test_a_key_change_is_named_by_its_first_token() -> None:
    """What the error of a call that changes its own key names: the first
    token that differs, after its module and attribute."""
    chain = _Scaled()
    chain.set_context("scale", {"factor": torch.full((4,), 2.0), "seen": []})
    program = graphs.Program(lambda m, x: m(x))
    x = torch.randn(3, 4)
    before = program.key(chain, x)
    chain.calls = 1
    assert graphs._first_difference(before, before) == f"the key went from {len(before)} to {len(before)} tokens"
    chain.calls = 2
    after = program.key(chain, x)
    chain.calls = 1
    message = graphs._first_difference(program.key(chain, x), after)
    assert "in _Scaled" in message and "('calls', 1) became ('calls', 2)" in message


def test_a_pipelines_programs_share_one_pool() -> None:
    """The loop and the decode never run at the same time: their graphs
    share one memory pool; another pipeline has its own."""
    sd = _port_sd1()
    pipe, other = TextToImage(sd, size=(64, 64)), TextToImage(sd, size=(64, 64))
    diffuse, decode = pipe._program("diffuse", _diffuse), pipe._program("decode", pipe._decode)
    assert diffuse.pool is decode.pool and other._program("diffuse", _diffuse).pool is not diffuse.pool
    assert graphs.Program(lambda x: x).pool is not graphs.Program(lambda x: x).pool


# -- nothing read back to the host ---------------------------------------------------


class _HostReads(TorchFunctionMode):
    """Records the operations that read a tensor back to the host or
    copy host data up (what a CUDA graph capture cannot hold)."""

    NAMES = frozenset(
        {"item", "__bool__", "tolist", "__int__", "__float__", "__index__", "numpy", "tensor", "as_tensor", "nonzero",
         "masked_select", "unique", "cpu"}  # fmt: skip
    )

    def __init__(self) -> None:
        super().__init__()
        self.found: list[str] = []

    def __torch_function__(self, func: Any, types: Any, args: Any = (), kwargs: Any = None) -> Any:
        name = getattr(func, "__name__", "")
        if name in ("__getitem__", "__setitem__") and len(args) > 1:
            index = args[1] if isinstance(args[1], tuple) else (args[1],)
            tensors = [i for i in index if isinstance(i, torch.Tensor)]
            if any(i.dtype == torch.bool for i in tensors):
                name = "a boolean index"  # waits for the count
            elif any(i.ndim == 0 for i in tensors):
                name = "a 0-dim tensor index"  # read back as a Python int
            elif name == "__setitem__" and not isinstance(args[2], torch.Tensor):
                name = "a host value written by indexing"  # copied up from a host scalar tensor
        if name in self.NAMES or name.startswith("a "):
            frame = [f for f in traceback.extract_stack()[:-1] if "/torch/" not in f.filename][-1]
            self.found.append(f"{name} at {frame.filename}:{frame.lineno}")
        return func(*args, **(kwargs or {}))


def _host_reads(fn: Any) -> list[str]:
    """What `fn` reads back when run a second time: a program's first call
    runs eagerly (lazy set-up there is fine), its capture is the second run."""
    fn()
    with _HostReads() as mode:
        fn()
    return sorted(set(mode.found))


@pytest.fixture(scope="module")
def sd1_16() -> StableDiffusion_1:
    return _port_sd1(steps=2)


ENCODER = {"image_size": 32, "embedding_dim": 64, "output_dim": 48, "patch_size": 16, "num_layers": 32,
           "num_attention_heads": 4, "feedforward_dim": 128}  # fmt: skip


def _adapter(sd: StableDiffusion_1, name: str) -> Any:
    """One of the adapters `chip_smoke.py` serves, injected, its condition set."""
    size = 8 * 2 * LATENT
    if name == "controlnet":
        adapter = SD1ControlnetAdapter(sd.unet, name="canny", scale=0.7, scale_decay=0.825).inject()
        adapter.set_controlnet_condition(torch.rand(1, 3, size, size))
    elif name == "t2i":
        adapter = SD1T2IAdapter(sd.unet, name="pose", scale=0.8, condition_encoder=T2IConditionEncoder(channels=(32, 64, 128, 128))).inject()
        adapter.set_condition_features(adapter.compute_condition_features(torch.rand(1, 3, size, size)))
    elif name == "freeu":
        adapter = SDFreeUAdapter(sd.unet, backbone_scales=[1.2, 1.4], skip_scales=[0.9, 0.2]).inject()
    elif name == "reference_only":
        adapter = ReferenceOnlyControlAdapter(sd.unet, style_cfg=0.5).inject()
        adapter.set_controlnet_condition(torch.randn(2, 4, 2 * LATENT, 2 * LATENT))
    elif name == "ip_adapter":
        adapter = SD1IPAdapter(sd.unet, clip_image_encoder=CLIPImageEncoder(**ENCODER)).inject()
        adapter.set_clip_image_embedding(adapter.compute_clip_image_embedding(torch.rand(1, 3, 32, 32)))
    elif name == "ella":
        adapter = SD1ELLAAdapter(sd.unet).inject()
        adapter.set_llm_text_embedding(torch.randn(2, 8, 2048))
    else:
        raise ValueError(name)
    return adapter


@pytest.mark.parametrize(
    "case",
    ["ddim", "dpm_sde", "euler", "lcm", "controlnet", "t2i", "freeu", "sag", "style_aligned", "reference_only",
     "ip_adapter", "ella"],  # fmt: skip
)
def test_the_loop_reads_nothing_back_to_the_host(sd1_16: StableDiffusion_1, case: str) -> None:
    """`TextToImage`'s loop (2 steps at 16² latents) under each solver
    and adapter: no host read inside it, so the card can capture it."""
    sd = sd1_16
    solvers = {"ddim": DDIM(2), "dpm_sde": DPMSolver(2, params=SolverParams(sde_variance=1.0)), "euler": Euler(2), "lcm": LCMSolver(2)}
    sd.solver = solvers.get(case, DDIM(2))
    x, emb = torch.randn(1, 4, 2 * LATENT, 2 * LATENT), torch.randn(2, 77, 768)
    adapter: Any = None
    if case == "sag":
        sd.set_self_attention_guidance(True, scale=0.75)
    elif case == "style_aligned":
        adapter = StyleAlignedAdapter(sd.unet, scale=0.8).inject()
        x, emb = torch.randn(2, 4, 2 * LATENT, 2 * LATENT), torch.randn(4, 77, 768)
    elif case not in solvers:
        adapter = _adapter(sd, case)
    try:
        with torch.inference_mode():
            found = _host_reads(lambda: TextToImage(sd)._program("diffuse", _diffuse)(sd, x, emb, 7.5, torch.Generator().manual_seed(0)))
    finally:
        sd.set_self_attention_guidance(False)
        if adapter is not None:
            adapter.eject()
    assert found == []


def test_restart_and_the_training_step_read_nothing_back_to_the_host(sd1_16: StableDiffusion_1) -> None:
    """Restart's loop (a request's own program in `chip_smoke.py`) and the
    SD1.5 training example's step (the ``jit_step`` program: its DDPM
    noising indexes the tables with the drawn steps on the device)."""
    from refiners_tpu_torch.examples.train_unet import CONFIG, UnetConfig, UnetTrainer

    sd = sd1_16
    sd.solver = DDIM(10)
    restart = Restart(ldm=sd, num_steps=4, num_iterations=2)
    x, emb = torch.randn(1, 4, 2 * LATENT, 2 * LATENT), torch.randn(2, 77, 768)
    with torch.inference_mode():
        found = _host_reads(lambda: restart(x, clip_text_embedding=emb, condition_scale=7.5, generator=torch.Generator().manual_seed(0)))
    assert found == []
    toml = CONFIG.replace('device = "cuda"', 'device = "cpu"').replace("[training]", "[training]\njit_step = true")
    trainer = UnetTrainer(UnetConfig.load_from_toml_string(toml), base_channels=32, batch_size=2, latent_size=8, num_batches=1)
    batch = trainer.data_iterable[0]
    found = _host_reads(lambda: trainer._loss_and_backward([trainer.unet], batch, 1, [trainer.generator]))
    assert found == []


# -- training.jit_step ----------------------------------------------------------------------


@pytest.mark.parametrize("case", ["sgd", "adamw"])
def test_jit_step_trainer_matches_the_jax_jit_step_trainer(case: str) -> None:
    """`mock_config.toml` (SGD, warmup, accumulation 4, clipping 1.0) and
    AdamW with clipping, ``jit_step = true`` in both packages: the port's
    step program (eager on the CPU) against JAX's jitted loss and gradient,
    step by step (learning rates, grad norms, weights); the gradients stay
    in the same tensors from step to step."""
    jax_config = JaxMockConfig.load_from_toml(MOCK_TOML)
    port_config = PortMockConfig.load_from_toml(MOCK_TOML)
    port_config.training.device = "cpu"
    _configure(jax_config, jtu, case)
    _configure(port_config, tu, case)
    jax_config.training.jit_step = port_config.training.jit_step = True
    jax_trainer, port_trainer = JaxMockTrainer(jax_config), PortMockTrainer(port_config)
    for name in ("mock_model", "mock_model_frozen"):
        load_jax_state_dict(getattr(port_trainer, name), {k: np.asarray(v) for k, v in getattr(jax_trainer, name).state_dict().items()})
    jax_trainer.train()
    port_trainer.train()
    jax_steps = [r for r in jax_trainer.records if isinstance(r, tuple)]
    port_steps = [r for r in port_trainer.records if isinstance(r, tuple)]
    assert len(port_steps) == len(jax_steps) == 4
    for (lr, norm, state), (jax_lr, jax_norm, jax_state) in zip(port_steps, jax_steps):
        assert lr == pytest.approx(jax_lr, rel=TRAINER_TOL, abs=1e-12)
        assert norm == pytest.approx(jax_norm, rel=TRAINER_TOL)
        for key, want in jax_state.items():
            assert _rel(state[key], want) <= TRAINER_TOL, key
    assert port_trainer._step_program is not None and port_trainer._step_program.captures == 0  # the CPU: eager
    grads = [p.grad for p in port_trainer.learnable_parameters]
    assert all(g is not None for g in grads)
    for batch in port_trainer.data_iterable[:4]:  # an optimizer step: the same gradient tensors, zeroed in place
        port_trainer.step(batch)
    assert all(p.grad is g for p, g in zip(port_trainer.learnable_parameters, grads))


# -- meshes --------------------------------------------------------------------------------


def test_a_gloo_mesh_runs_the_programs_eagerly(tmp_path: Any) -> None:
    """gloo runs its collectives on the host, which a CUDA graph cannot
    hold: `TextToImage` on a gloo mesh calls its functions directly (NCCL
    meshes are captured: `chip_smoke.py` phase 14a)."""
    import torch.distributed as dist

    from refiners_tpu_torch.parallel import init_process_group, make_mesh

    init_process_group("gloo", init_method=f"file://{tmp_path}/store", rank=0, world_size=1)
    try:
        mesh = make_mesh(device_type="cpu")
        assert graphs.eager_on(mesh) and not graphs.eager_on(None)
        pipe = TextToImage(_port_sd1(), size=(64, 64), mesh=mesh)
        program = pipe._program("diffuse", _diffuse)
        assert program.runs_eagerly and pipe._program("decode", pipe._decode).runs_eagerly
        seen: list[Any] = []
        program.fn = lambda *args, **kwargs: seen.append((args, kwargs))  # called as written: no walk, no key
        program(object(), x=1)
        assert len(seen) == 1 and program.captures == 0
    finally:
        dist.destroy_process_group()
