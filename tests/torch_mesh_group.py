"""A group of CPU ranks over gloo for the port's mesh tests, and what the ranks run.

A test file writes its inputs (the JAX models' weights and the data, as numpy)
to a directory, starts one group of `WORLD` ranks (`start_group`) that runs
every case of the file, computes the JAX side while the ranks run, and reads
rank 0's results (`Group.results`). This module imports no JAX: the ranks run
the port alone, one thread each, joined through a ``file://`` store in the
directory (no TCP port). Every rank runs every case; a case that raises on any
rank is recorded with its traceback, and the group goes on to the next case.
"""

from __future__ import annotations

import datetime
import importlib
import pickle
import time
import traceback
import zlib
from dataclasses import dataclass
from pathlib import Path
from typing import Any, Callable

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

import refiners_tpu_torch.fluxion.layers as fl
import refiners_tpu_torch.training_utils as tu
from refiners_tpu_torch.fluxion import manual_seed
from refiners_tpu_torch.training_utils.config import MeshConfig

WORLD = 4
GROUP_TIMEOUT_S = 240.0  # the whole group, spawn included; the ranks are killed after it
COLLECTIVE_TIMEOUT = datetime.timedelta(seconds=60)  # a rank left waiting by one that raised


@dataclass
class Group:
    context: Any
    directory: Path
    deadline: float

    def results(self) -> dict[str, Any]:
        """Wait for the ranks (killing them past the deadline) and return rank 0's results."""
        try:
            while not self.context.join(timeout=1.0):
                if time.monotonic() > self.deadline:
                    raise TimeoutError(f"the rank group outlived {GROUP_TIMEOUT_S} s")
        finally:
            for process in self.context.processes:
                if process.is_alive():
                    process.kill()
                process.join()
        with open(self.directory / "results.pkl", "rb") as f:
            return pickle.load(f)


def start_group(directory: Path, cases: str) -> Group:
    """Spawn `WORLD` ranks that call `cases` ("module:function", the function
    taking the directory and returning a dict of case → result) and return
    at once."""
    context = mp.start_processes(
        _rank, args=(str(directory), cases), nprocs=WORLD, start_method="spawn", join=False
    )
    return Group(context, directory, time.monotonic() + GROUP_TIMEOUT_S)


def _rank(rank: int, directory: str, cases: str) -> None:
    torch.set_num_threads(1)
    from refiners_tpu_torch.parallel import init_process_group

    init_process_group(
        "gloo", init_method=f"file://{directory}/store", rank=rank, world_size=WORLD, timeout=COLLECTIVE_TIMEOUT
    )
    module, name = cases.split(":")
    results = getattr(importlib.import_module(module), name)(Path(directory))
    if rank == 0:
        with open(Path(directory) / "results.pkl", "wb") as f:
            pickle.dump(results, f)
    dist.barrier()
    dist.destroy_process_group()


def run_cases(cases: dict[str, Callable[[], Any]]) -> dict[str, Any]:
    """Run each case on this rank; a case failed if it raised on any rank."""
    results: dict[str, Any] = {}
    for name, case in cases.items():
        try:
            result, ok = case(), 1
        except Exception:  # recorded, and reported by the test that reads the case
            result, ok = {"error": traceback.format_exc()}, 0
        flag = torch.tensor([ok])
        dist.all_reduce(flag, op=dist.ReduceOp.MIN)
        if ok and not flag.item():
            result = {"error": "the case raised on another rank"}
        results[name] = result
    return results


# -- shared inputs -------------------------------------------------------------------------


def fake_text_embedding(text: str) -> np.ndarray:
    """A deterministic (77, 768) embedding of `text` (a seed from its CRC32):
    the text encoder of the pipeline tests, in both packages."""
    return np.random.RandomState(zlib.crc32(text.encode())).randn(77, 768).astype(np.float32)


class FakeTextEncoder(fl.Module):
    """Maps list[str] → (N, 77, 768) `fake_text_embedding`s (no weights)."""

    def forward(self, texts: list[str]) -> torch.Tensor:
        return torch.stack([torch.from_numpy(fake_text_embedding(t)) for t in texts])


class FakeLDA(fl.Module):
    """Stand-in VAE: decode = tanh of three latent channels, nearest-upsampled ×8 (NCHW)."""

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        return self.decode(z)

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        return torch.tanh(z[:, :3]).repeat_interleave(8, dim=2).repeat_interleave(8, dim=3)


def _load(directory: Path, name: str) -> dict[str, np.ndarray]:
    with np.load(directory / f"{name}.npz") as f:
        return dict(f)


def _bridged(module: fl.Module, directory: Path, name: str) -> fl.Module:
    from refiners_tpu_torch.conversion import load_jax_state_dict

    load_jax_state_dict(module, _load(directory, name))
    return module


def _full(t: torch.Tensor) -> np.ndarray:
    from torch.distributed.tensor import DTensor

    return (t.full_tensor() if isinstance(t, DTensor) else t).detach().numpy().copy()


def _layout(module: torch.nn.Module) -> dict[str, Any]:
    """Each parameter's placement ("Shard(dim)", "Replicate", or "replicated"
    for a plain tensor) and local shape."""
    from torch.distributed.tensor import DTensor, Shard

    def place(p: torch.Tensor) -> str:
        if not isinstance(p, DTensor):
            return "replicated"
        (placement,) = p.placements
        return f"Shard({placement.dim})" if isinstance(placement, Shard) else "Replicate"

    def local_shape(p: torch.Tensor) -> tuple[int, ...]:
        return tuple((p.to_local() if isinstance(p, DTensor) else p).shape)

    return {k: (place(p), local_shape(p)) for k, p in module.named_parameters()}


# -- test_torch_parallel.py --------------------------------------------------------------------


def _sd1_unet(directory: Path) -> fl.Module:
    from refiners_tpu_torch.foundationals.latent_diffusion import SD1UNet

    return _bridged(SD1UNet(in_channels=4, base_channels=32, device="cpu"), directory, "unet")


def _sd1(directory: Path, lda: fl.Module | None = None, steps: int = 3) -> Any:
    from refiners_tpu_torch.foundationals.latent_diffusion import DDIM, StableDiffusion_1

    return StableDiffusion_1(
        unet=_sd1_unet(directory), lda=lda or FakeLDA(), clip_text_encoder=FakeTextEncoder(),
        solver=DDIM(num_inference_steps=steps, device="cpu"), device="cpu",
    )  # fmt: skip


SAG_SIZE = (128, 128)  # 16² latents: the reduced UNet's middle block at 2², where SAG's mask is not trivial
SAG_SCALE = 0.75
SAG_STEPS = 1  # the JAX side compiles its denoising loop unrolled: one step keeps it to a few seconds


def parallel_cases(directory: Path) -> dict[str, Any]:
    from torch.distributed.tensor import DTensor

    from refiners_tpu_torch.foundationals.latent_diffusion.cross_attention import CrossAttentionBlock2d
    from refiners_tpu_torch.parallel import data_sharding, make_mesh, shard_inputs, shard_latent_diffusion, shard_module
    from refiners_tpu_torch.pipelines import TextToImage

    data = _load(directory, "inputs")
    rank = dist.get_rank()

    def mesh_case() -> dict[str, Any]:
        out: dict[str, Any] = {}
        for args in ({"tensor": 2}, {}, {"data": 4}, {"data": 1, "tensor": 4}):
            mesh = make_mesh(device_type="cpu", **args)
            out[repr(args)] = (tuple(mesh.shape), mesh.mesh_dim_names, mesh.get_coordinate())
        sub = make_mesh(data=2, tensor=1, device_type="cpu", ranks=[0, 1])
        out["sub"] = (tuple(sub.shape), sub.get_coordinate())
        for args in ({"data": 3}, {"tensor": 3}, {"data": 2, "tensor": 1}):
            try:
                make_mesh(device_type="cpu", **args)
                out[f"raises {args}"] = None
            except AssertionError as e:
                out[f"raises {args}"] = str(e)
        try:
            make_mesh(tensor=2)  # cuda by default: there is none here
            out["cuda"] = None
        except RuntimeError as e:
            out["cuda"] = str(e)
        return out

    def block_case(data_size: int, tensor: int, name: str = "block", heads: int = 4) -> Callable[[], dict[str, Any]]:
        def case() -> dict[str, Any]:
            block = _bridged(
                CrossAttentionBlock2d(channels=data[f"{name}_x"].shape[1], context_embedding_dim=96,
                                      context_key="clip_text_embedding", num_attention_heads=heads,
                                      use_linear_projection=True),
                directory, name,
            )  # fmt: skip
            mesh = make_mesh(data=data_size, tensor=tensor, device_type="cpu")
            shard_module(block, mesh)
            x, text = shard_inputs(mesh, torch.from_numpy(data[f"{name}_x"]), torch.from_numpy(data["block_text"]))
            block.set_context("cross_attention_block", {"clip_text_embedding": text})
            with torch.no_grad():
                out = data_sharding(mesh, 4).gather(block(x))
            return {"out": out.numpy(), "layout": _layout(block)}

        return case

    def attention_case(name: str, embedding_dim: int, num_heads: int) -> Callable[[], dict[str, Any]]:
        def case() -> dict[str, Any]:
            attention = fl.Chain(fl.SelfAttention(embedding_dim=embedding_dim, num_heads=num_heads))
            _bridged(attention, directory, name)
            mesh = make_mesh(data=2, tensor=2, device_type="cpu")
            shard_module(attention, mesh)
            sdpa = attention.ensure_find(fl.ScaledDotProductAttention)
            with torch.no_grad():
                out = data_sharding(mesh, 3).gather(attention(shard_inputs(mesh, torch.from_numpy(data[name]))[0]))
            return {"out": out.numpy(), "layout": _layout(attention), "local_heads": sdpa.num_heads}

        return case

    def unet_case(data_size: int, tensor: int) -> Callable[[], dict[str, Any] | None]:
        def case() -> dict[str, Any] | None:
            unet = _sd1_unet(directory)
            mesh = make_mesh(data=data_size, tensor=tensor, device_type="cpu", ranks=range(data_size * tensor))
            shard_module(unet, mesh)
            if mesh.get_coordinate() is None:
                return None
            x, text = shard_inputs(mesh, torch.from_numpy(data["unet_x"]), torch.from_numpy(data["unet_text"]))
            unet.set_timestep(torch.tensor([500]))
            unet.set_clip_text_embedding(text)
            with torch.no_grad():
                out = data_sharding(mesh, 4).gather(unet(x))
            split = sum(1 for _, (place, _) in _layout(unet).items() if place.startswith("Shard"))
            return {"out": out.numpy(), "split": split}

        return case

    def placement_case() -> dict[str, Any]:
        from refiners_tpu_torch.foundationals.latent_diffusion.stable_diffusion_1 import SD1Autoencoder

        sd = _sd1(directory, lda=SD1Autoencoder(device="cpu"))
        with torch.no_grad():  # a VAE of its own on each rank: the placement gives every rank rank 0's
            for p in sd.lda.parameters():
                p.add_(rank)
        mesh = make_mesh(data=2, tensor=2, device_type="cpu")
        shard_latent_diffusion(sd, mesh)
        lda = [p.detach().clone() for p in sd.lda.parameters()]
        gathered = [torch.empty_like(lda[0]) for _ in range(dist.get_world_size())]
        dist.all_gather(gathered, lda[0])
        return {
            "unet": _layout(sd.unet), "lda": _layout(sd.lda), "solver": _layout(sd.solver),
            "lda_equal_across_ranks": all(torch.equal(g, gathered[0]) for g in gathered),
            "mesh_kept": sd.mesh is mesh, "timesteps": sd.solver.timesteps.numpy(),
        }  # fmt: skip

    def text_to_image_case(num_images: int) -> Callable[[], dict[str, Any]]:
        def case() -> dict[str, Any]:
            mesh = make_mesh(data=2, tensor=2, device_type="cpu")
            pipe = TextToImage(_sd1(directory), size=(64, 64), mesh=mesh, num_images=num_images)
            images = pipe("a photo of a cat", seed=42)
            images = images if isinstance(images, list) else [images]
            single = TextToImage(_sd1(directory), size=(64, 64), num_images=num_images)("a photo of a cat", seed=42)
            single = single if isinstance(single, list) else [single]
            manual_seed(rank)  # without a seed each rank's own stream: the ranks must still draw the same noise
            unseeded = pipe("a photo of a cat")
            digest = torch.tensor([zlib.crc32(np.asarray(unseeded if num_images == 1 else unseeded[0]).tobytes())])
            digests = [torch.empty_like(digest) for _ in range(dist.get_world_size())]
            dist.all_gather(digests, digest)
            return {"images": [np.asarray(i) for i in images], "single": [np.asarray(i) for i in single],
                    "sharded": pipe._sharded, "unseeded_equal": all(torch.equal(d, digest) for d in digests)}  # fmt: skip

        return case

    def sag_case(data_size: int, tensor: int) -> Callable[[], dict[str, Any] | None]:
        def case() -> dict[str, Any] | None:
            mesh = make_mesh(data=data_size, tensor=tensor, device_type="cpu", ranks=range(data_size * tensor))
            sd = _sd1(directory, steps=SAG_STEPS)
            sd.set_self_attention_guidance(True, scale=SAG_SCALE)
            if mesh.get_coordinate() is None:
                return None
            pipe = TextToImage(sd, size=SAG_SIZE, mesh=mesh)
            image = np.asarray(pipe("a photo of a cat", seed=42))
            single = TextToImage(_sd1(directory, steps=SAG_STEPS), size=SAG_SIZE)
            single.sd.set_self_attention_guidance(True, scale=SAG_SCALE)
            middle = next(m for k, m in sd.unet.named_modules() if "MiddleBlock" in k and k.endswith("SelfAttention"))
            return {"image": image, "single": np.asarray(single("a photo of a cat", seed=42)),
                    "middle_attention_split": any(isinstance(p, DTensor) for p in middle.parameters()),
                    "split": sum(1 for place, _ in _layout(sd.unet).values() if place.startswith("Shard"))}  # fmt: skip

        return case

    def contexts_case(data_size: int, tensor: int) -> dict[str, Any]:
        from refiners_tpu_torch.parallel.inference import ROW_OUTPUTS, run_unet

        mesh = make_mesh(data=data_size, tensor=tensor, device_type="cpu")
        (context, key), = ROW_OUTPUTS
        unet = fl.Chain(
            fl.Chain(fl.Sum(fl.Identity(), fl.UseContext("extra", "bias")), fl.Sum(fl.Identity(), fl.UseContext("extra", "shift"))),
            fl.SetContext(context, key),  # where SAG's map is recorded
        )  # fmt: skip
        x, bias = torch.from_numpy(data["unet_x"]), torch.from_numpy(data["unet_x"][::-1].copy())
        shift = torch.full((1, 4, 1, 1), 2.0)
        unet.set_context("extra", {"bias": torch.zeros_like(bias), "shift": shift})
        unet.set_context("extra", {"bias": bias, "shift": shift})  # replaced: the inner chains keep copies
        unet.set_context("extra", {"shift": shift})  # as SDXL sets "diffusion": the UNet's dict lacks the bias
        unet.set_context(context, {key: None})
        out = run_unet(unet, mesh, x)
        inner = unet[0][0].use_context("extra")
        return {"out": out.numpy(), "want": (x + bias + shift).numpy(), "bias_restored": inner["bias"] is bias,
                "root_lacks_bias": "bias" not in unet.use_context("extra"), "shift_kept": inner["shift"] is shift,
                "recorded": unet.use_context(context)[key].numpy()}  # fmt: skip

    def refusal_case() -> dict[str, Any]:
        from refiners_tpu_torch.parallel.inference import run_unet

        class ReadsOtherRows(fl.Module):
            """A stand-in for a layer that mixes the rows of its batch and has no handling of a split."""

            reads_other_rows = True

            def forward(self, x: torch.Tensor) -> torch.Tensor:
                return x.flip(0)

        unet = fl.Chain(fl.Identity(), ReadsOtherRows())
        x = torch.from_numpy(data["unet_x"])  # a batch of 4
        out: dict[str, Any] = {"want": x.flip(0).numpy()}
        try:  # the batch split over "data": the layer would see this rank's rows only
            run_unet(unet, make_mesh(data=2, tensor=2, device_type="cpu"), x)
        except ValueError as e:
            out["split"] = str(e)
        out["whole"] = run_unet(unet, make_mesh(data=1, tensor=4, device_type="cpu"), x).numpy()
        out["indivisible"] = run_unet(unet, make_mesh(data=4, tensor=1, device_type="cpu"), x[:2]).numpy()
        return out

    cases: dict[str, Callable[[], Any]] = {"mesh": mesh_case}
    cases.update({f"block {d}x{t}": block_case(d, t) for d, t in ((2, 2), (1, 4))})
    cases["block 10 heads 1x4"] = block_case(1, 4, "block10", heads=10)
    cases["attention 8 heads"] = attention_case("attn8", 512, 8)
    cases["attention 1 head"] = attention_case("attn1", 64, 1)
    cases.update({f"unet {d}x{t}": unet_case(d, t) for d, t in ((2, 1), (1, 2), (2, 2), (4, 1))})
    cases["placement"] = placement_case
    cases.update({f"text_to_image {n}": text_to_image_case(n) for n in (1, 4)})
    cases.update({f"sag {d}x{t}": sag_case(d, t) for d, t in ((2, 1), (2, 2))})
    cases.update({f"contexts {d}x{t}": (lambda d=d, t=t: contexts_case(d, t)) for d, t in ((4, 1), (2, 2))})
    cases["refusals"] = refusal_case
    return run_cases(cases)


# -- test_torch_parallel_coupled.py --------------------------------------------------------------

COUPLED_SIZE = (128, 128)  # 16² latents: StyleAligned's statistics over the middle block's 2² tokens
COUPLED_IMAGES = 4  # a CFG batch of 8: at 4x1 two rows a rank, half of them without their reference
COUPLED_STEPS = 1  # the JAX side compiles its denoising loop unrolled
STYLE_ALIGNED_SCALE = 0.8


def _coupled_sd1(directory: Path, adapter: str) -> Any:
    """The reduced SD1.5 (`_sd1`) with StyleAligned or reference-only control
    (its guide: the file's latents, a CFG batch) injected, or none."""
    from refiners_tpu_torch.foundationals.latent_diffusion import ReferenceOnlyControlAdapter, StyleAlignedAdapter

    sd = _sd1(directory, steps=COUPLED_STEPS)
    if adapter == "style_aligned":
        StyleAlignedAdapter(sd.unet, scale=STYLE_ALIGNED_SCALE).inject()
    elif adapter == "reference_only":
        guide = torch.from_numpy(_load(directory, "coupled")["guide"])
        ReferenceOnlyControlAdapter(sd.unet).inject().set_controlnet_condition(guide)
    return sd


def coupled_cases(directory: Path) -> dict[str, Any]:
    """StyleAligned and reference-only control with the CFG batch split over
    "data", and SAG entered after a "tensor" split: what each rank returns,
    and (rank 0) the same requests in one process."""
    import logging

    from torch.distributed.tensor import DTensor

    from refiners_tpu_torch.parallel import make_mesh
    from refiners_tpu_torch.pipelines import TextToImage

    rank = dist.get_rank()

    def request(sd: Any, mesh: Any = None, size: tuple[int, int] = COUPLED_SIZE, n: int = COUPLED_IMAGES) -> dict[str, Any]:
        """The images of a `TextToImage` request, then the CFG-combined noise
        prediction of its first step (`predict_noise` on the request's
        initial latents: on the mesh, through `run_unet`)."""
        pipe = TextToImage(sd, size=size, mesh=mesh, num_images=n)
        pipe._sharded = sd.mesh is not None  # a model already placed stays as it is
        images = pipe("a photo of a cat", seed=42)
        noise = torch.randn((n, 4, size[0] // 8, size[1] // 8), generator=torch.Generator().manual_seed(42))
        with torch.inference_mode():
            emb = sd.compute_clip_text_embedding("a photo of a cat", "").repeat_interleave(n, dim=0)
            x = sd.solver.scale_model_input(noise, step=-1)
            prediction = sd.predict_noise(x, 0, clip_text_embedding=emb, condition_scale=7.5)
        images = images if isinstance(images, list) else [images]
        return {"images": [np.asarray(i) for i in images], "prediction": prediction.numpy()}

    def coupled_case(adapter: str, data_size: int, tensor: int = 1) -> Callable[[], dict[str, Any] | None]:
        def case() -> dict[str, Any] | None:
            mesh = make_mesh(data=data_size, tensor=tensor, device_type="cpu", ranks=range(data_size * tensor))
            if mesh.get_coordinate() is None:
                return None
            out: dict[str, Any] = {"mesh": request(_coupled_sd1(directory, adapter), mesh)}
            if rank == 0:
                out["single"] = request(_coupled_sd1(directory, adapter))
                out["bare"] = request(_coupled_sd1(directory, "none"))
            return out

        return case

    def late_sag_case() -> dict[str, Any] | None:
        mesh = make_mesh(data=1, tensor=2, device_type="cpu", ranks=range(2))
        if mesh.get_coordinate() is None:
            return None
        records: list[str] = []
        handler = logging.Handler()
        handler.emit = lambda record: records.append(record.getMessage())  # type: ignore[method-assign]
        logger = logging.getLogger("refiners_tpu_torch.parallel.inference")
        logger.addHandler(handler)
        try:
            sd = _sd1(directory, steps=SAG_STEPS)
            TextToImage(sd, size=SAG_SIZE, mesh=mesh)("a photo of a cat", seed=42)  # placed: the attentions split
            sd.set_self_attention_guidance(True, scale=SAG_SCALE)
            late = [request(sd, mesh, SAG_SIZE, 1) for _ in range(2)]
        finally:
            logger.removeHandler(handler)
        early = _sd1(directory, steps=SAG_STEPS)
        early.set_self_attention_guidance(True, scale=SAG_SCALE)
        attentions = {k: m for k, m in sd.unet.named_modules() if isinstance(m, fl.SelfAttention)}
        split = {k for k, m in attentions.items() if any(isinstance(p, DTensor) for p in m.parameters())}
        return {"late": late, "early": request(early, mesh, SAG_SIZE, 1), "records": records,
                "whole": sorted(set(attentions) - split), "split": len(split)}  # fmt: skip

    cases: dict[str, Callable[[], Any]] = {}
    for adapter in ("style_aligned", "reference_only"):
        cases.update({f"{adapter} {d}x1": coupled_case(adapter, d) for d in (2, 4)})
    cases["reference_only 1x2"] = coupled_case("reference_only", 1, 2)  # its guided copy shares the split heads
    cases["late sag 1x2"] = late_sag_case
    return run_cases(cases)


# -- test_torch_parallel_training.py ---------------------------------------------------------------


def toy_transformer() -> fl.Chain:
    """The JAX sharding test's toy transformer (tests/parallel/test_sharding.py)."""
    from refiners_tpu_torch.foundationals.clip.common import FeedForward

    return fl.Chain(
        fl.Residual(fl.LayerNorm(64), fl.SelfAttention(embedding_dim=64, num_heads=4)),
        fl.Residual(fl.LayerNorm(64), FeedForward(embedding_dim=64, feedforward_dim=128)),
    )


def mock_batches() -> list[dict[str, torch.Tensor]]:
    rs = np.random.RandomState(0)
    return [
        {"inputs": torch.from_numpy(rs.randn(8, 7, 16).astype(np.float32)),
         "targets": torch.from_numpy(rs.randn(8, 7, 16).astype(np.float32))}
        for _ in range(8)
    ]  # fmt: skip


class MockConfig(tu.BaseConfig):
    mock_model: tu.ModelConfig
    mock_model_frozen: tu.ModelConfig
    recorder: tu.CallbackConfig = tu.CallbackConfig()


class Recorder(tu.Callback[Any]):
    """At each optimizer step's end: the loss, the grad norm, the learning
    rate and the trained model's whole weights."""

    def __init__(self) -> None:
        self.records: list[dict[str, Any]] = []

    def on_optimizer_step_end(self, trainer: Any) -> None:
        self.records.append({
            "loss": float(trainer.loss.detach()), "grad_norm": trainer.grad_norm, "lr": trainer.current_learning_rate(),
            "weights": {k: _full(v) for k, v in trainer.mock_model.state_dict().items()},
        })  # fmt: skip


class MockTrainer(tu.Trainer[MockConfig, dict[str, torch.Tensor]]):
    """Trains the JAX mesh test's net (a Linear, a 4-head self-attention, a
    Linear; tests/training_utils/test_trainer_mesh.py) on `mock_batches`,
    from `initial_weights` (the JAX trainer's, in its layout) if given; the
    attention's projections without biases unless `attention_bias`."""

    initial_weights: dict[str, np.ndarray] | None = None
    attention_bias: bool = True

    @tu.register_model()
    def mock_model(self, config: tu.ModelConfig) -> fl.Chain:
        manual_seed(0)
        model = fl.Chain(
            fl.Linear(16, 32), fl.SelfAttention(embedding_dim=32, num_heads=4, use_bias=self.attention_bias),
            fl.Linear(32, 16),
        )  # fmt: skip
        if self.initial_weights is not None:
            from refiners_tpu_torch.conversion import load_jax_state_dict

            load_jax_state_dict(model, self.initial_weights)
        return model

    @tu.register_model()
    def mock_model_frozen(self, config: tu.ModelConfig) -> fl.Chain:
        return fl.Chain(fl.Linear(16, 16))

    @tu.register_callback()
    def recorder(self, config: tu.CallbackConfig) -> Recorder:
        return Recorder()

    def create_data_iterable(self) -> list[dict[str, torch.Tensor]]:
        return mock_batches()

    def compute_loss(self, batch: dict[str, torch.Tensor]) -> torch.Tensor:
        dtype = self.mock_model.dtype
        return torch.mean((self.mock_model(batch["inputs"].to(dtype)) - batch["targets"].to(dtype)) ** 2)


# each optimizer with a learning rate at which 2 steps move the weights well past float32 noise
LEARNING_RATES = {"SGD": 1.0, "AdamW": 1e-2, "Lion8bit": 1e-3, "Prodigy": 1.0}


def mock_trainer(
    mesh: dict[str, int] | None,
    weights: dict[str, np.ndarray] | None = None,
    optimizer: str = "SGD",
    attention_bias: bool = True,
    dtype: str = "float32",
    iterations: int = 2,
) -> MockTrainer:
    """`MockTrainer` on ``tests/training_utils/mock_config.toml`` (SGD at lr
    1.0, gradient accumulation 4, clipping), its warmup off and its clipping
    at 0.02 (active), for `iterations` optimizer steps (2 an epoch of 8
    batches of 8); under ``[training.mesh]`` `mesh` if given; from `weights`
    if given; with `optimizer` at its `LEARNING_RATES` rate; in `dtype`."""
    config = MockConfig.load_from_toml(Path(__file__).parent / "training_utils" / "mock_config.toml")
    config.training.device = "cpu"
    config.training.duration = tu.Iteration(iterations)
    config.training.gradient_clipping_max_norm = 0.02
    config.lr_scheduler.warmup = tu.Iteration(0)
    config.training.mesh = MeshConfig(**mesh) if mesh is not None else None
    config.optimizer.optimizer = tu.Optimizers(optimizer)
    config.optimizer.learning_rate = LEARNING_RATES[optimizer]
    config.training.dtype = dtype
    attributes = {"initial_weights": weights, "attention_bias": attention_bias}
    return type("MockTrainer", (MockTrainer,), attributes)(config)


# Adam's and Lion's first steps are near lr·sign(gradient): the optimizer cases
# drop the attention's projection biases (a key bias has an exactly zero
# gradient, a shift of every key leaving the softmax as it is, so its
# gradient is rounding noise, and so its step) and run in float64.
OPTIMIZER_CASE = (False, "float64")


def _optimizer_state(trainer: MockTrainer) -> dict[str, dict[str, Any]]:
    """The trained model's optimizer state by parameter name, whole tensors."""
    optimizer = trainer.models["mock_model"].optimizer
    assert optimizer is not None
    return {
        name: {k: _full(v) if isinstance(v, torch.Tensor) else v for k, v in optimizer.state[p].items()}
        for name, p in trainer.mock_model.named_parameters()
    }


def training_cases(directory: Path) -> dict[str, Any]:
    from torch.distributed.tensor import DTensor

    from refiners_tpu_torch.parallel import make_mesh, shard_inputs, shard_module

    data = _load(directory, "inputs")

    def grads_case(data_size: int, tensor: int) -> Callable[[], dict[str, Any]]:
        def case() -> dict[str, Any]:
            model = _bridged(toy_transformer(), directory, "toy")
            mesh = make_mesh(data=data_size, tensor=tensor, device_type="cpu")
            shard_module(model, mesh)
            (x,) = shard_inputs(mesh, torch.from_numpy(data["toy_x"]))
            torch.mean(model(x) ** 2).backward()
            group = mesh.get_group("data")
            grads = {}
            for k, p in model.named_parameters():
                from torch.distributed.tensor import DTensor

                local = p.grad.to_local() if isinstance(p.grad, DTensor) else p.grad
                dist.all_reduce(local, group=group)
                local.div_(data_size)
                grads[k] = _full(p.grad)
            return {"grads": grads, "layout": _layout(model)}

        return case

    weights = _load(directory, "mock")

    def trainer_case(data_size: int, tensor: int, optimizer: str = "SGD") -> Callable[[], dict[str, Any]]:
        def case() -> dict[str, Any]:
            if optimizer == "SGD":
                trainer = mock_trainer({"data": data_size, "tensor": tensor}, weights)
            else:
                trainer = mock_trainer({"data": data_size, "tensor": tensor}, None, optimizer, *OPTIMIZER_CASE)
            trainer.train()
            optimizer_ = trainer.models["mock_model"].optimizer
            groups = [{isinstance(p, DTensor) for p in group["params"]} for group in optimizer_.param_groups]
            return {"records": trainer.recorder.records, "layout": _layout(trainer.mock_model),
                    "mesh": tuple(trainer.mesh.shape), "steps": trainer.clock.step, "groups": groups}  # fmt: skip

        return case

    def checkpoint_case(data_size: int, tensor: int) -> Callable[[], dict[str, Any]]:
        def case() -> dict[str, Any]:
            from refiners_tpu_torch.training_utils.checkpointing import CheckpointCallback, CheckpointConfig

            mesh = {"data": data_size, "tensor": tensor}
            folder = directory / f"checkpoints {data_size}x{tensor}"
            callback = CheckpointCallback(CheckpointConfig(directory=str(folder), interval="100:epoch", keep=1))
            trainer = mock_trainer(mesh, weights, "AdamW")
            trainer.train()
            callback.save(trainer, "first")
            callback.save(trainer, "final")  # pruned: `first` goes, once
            fresh = mock_trainer(mesh, weights, "AdamW")
            callback.restore(fresh, "final")
            callback.on_train_begin(fresh)
            saved = torch.load(folder / "final" / "state.pt", weights_only=True)
            return {
                "trained": {k: _full(v) for k, v in trainer.mock_model.state_dict().items()},
                "restored": {k: _full(v) for k, v in fresh.mock_model.state_dict().items()},
                "restored_layout": _layout(fresh.mock_model),
                "trained_state": _optimizer_state(trainer), "restored_state": _optimizer_state(fresh),
                "saved_shapes": {k: tuple(v.shape) for k, v in saved["model_mock_model"].items()},
                "saved_types": sorted({type(v).__name__ for v in saved["model_mock_model"].values()}),
                "tags": sorted(p.name for p in folder.iterdir()), "steps": (trainer.clock.step, fresh.clock.step),
            }  # fmt: skip

        return case

    def resume_case(saved_at: tuple[int, int], restored_at: tuple[int, int]) -> Callable[[], dict[str, Any]]:
        """AdamW (`OPTIMIZER_CASE`) for 2 optimizer steps at `saved_at`, saved;
        a fresh 4-step Trainer at `restored_at` restored from it trains on;
        and the 4 steps straight through at `restored_at`."""

        def case() -> dict[str, Any]:
            from refiners_tpu_torch.training_utils.checkpointing import CheckpointCallback, CheckpointConfig

            (d0, t0), (d1, t1) = saved_at, restored_at
            folder = directory / f"resume {d0}x{t0} to {d1}x{t1}"
            callback = CheckpointCallback(CheckpointConfig(directory=str(folder), interval="100:epoch", keep=1))
            first = mock_trainer({"data": d0, "tensor": t0}, None, "AdamW", *OPTIMIZER_CASE)
            first.train()
            callback.save(first, "resume", epochs_done=1)
            resumed = mock_trainer({"data": d1, "tensor": t1}, None, "AdamW", *OPTIMIZER_CASE, iterations=4)
            resumed.callbacks["checkpoint"] = callback  # after the clock: puts the restored counters back
            callback.restore(resumed, "resume")
            groups = [len(group["params"]) for group in resumed.models["mock_model"].optimizer.param_groups]
            resumed.train()
            straight = mock_trainer({"data": d1, "tensor": t1}, None, "AdamW", *OPTIMIZER_CASE, iterations=4)
            straight.train()
            saved = torch.load(folder / "resume" / "state.pt", weights_only=True)["opt_mock_model"]
            return {"records": resumed.recorder.records, "straight": straight.recorder.records, "groups": groups,
                    "saved_groups": [group["params"] for group in saved["param_groups"]],
                    "saved_state": sorted(saved["state"]), "steps": resumed.clock.step}  # fmt: skip

        return case

    def loggers_case() -> dict[str, list[int]]:
        import sys
        import types

        from refiners_tpu_torch.training_utils.neptune import NeptuneCallback, NeptuneConfig
        from refiners_tpu_torch.training_utils.wandb import WandbCallback, WandbConfig

        started: list[str] = []
        stubs = {"wandb": types.SimpleNamespace(init=lambda **_: started.append("wandb")),
                 "neptune": types.SimpleNamespace(init_run=lambda **_: started.append("neptune"))}  # fmt: skip
        saved = {name: sys.modules.get(name) for name in stubs}
        sys.modules.update(stubs)  # type: ignore[arg-type]
        try:
            wandb, neptune = WandbCallback(WandbConfig()), NeptuneCallback(NeptuneConfig())
            wandb.log({"x": 1.0}, step=0)  # a rank without a run logs nothing, and does not fail
            neptune.log("x", 1.0)
        finally:
            for name, module in saved.items():
                if module is None:
                    sys.modules.pop(name)
                else:
                    sys.modules[name] = module
        flags = torch.tensor([len(started)])
        gathered = [torch.empty_like(flags) for _ in range(dist.get_world_size())]
        dist.all_gather(gathered, flags)
        return {"runs_by_rank": [int(g) for g in gathered]}

    def foreach_case() -> dict[str, str]:
        """torch's multi-tensor AdamW (the default on the card) over a model
        with split and whole parameters, as given and grouped by type."""
        from refiners_tpu_torch.training_utils.config import _by_type

        trainer = mock_trainer({"data": 2, "tensor": 2}, weights)
        params = list(trainer.mock_model.parameters())
        out: dict[str, str] = {}
        for label, groups in (("as given", params), ("by type", _by_type(params))):
            for p in params:
                p.grad = torch.ones_like(p)
            try:
                torch.optim.AdamW(groups, lr=1e-3, foreach=True).step()
                out[label] = "stepped"
            except RuntimeError as e:
                out[label] = str(e)
        return out

    cases: dict[str, Callable[[], Any]] = {f"grads {d}x{t}": grads_case(d, t) for d, t in ((4, 1), (2, 2))}
    cases["loggers"] = loggers_case
    cases["foreach"] = foreach_case
    cases.update({f"trainer {d}x{t}": trainer_case(d, t) for d, t in ((4, 1), (2, 2))})
    cases.update({f"trainer 2x2 {name}": trainer_case(2, 2, name) for name in ("AdamW", "Lion8bit", "Prodigy")})
    cases.update({f"checkpoint {d}x{t}": checkpoint_case(d, t) for d, t in ((4, 1), (2, 2))})
    for a, b in (((2, 2), (4, 1)), ((2, 2), (2, 2)), ((4, 1), (2, 2))):
        cases[f"resume {a[0]}x{a[1]} to {b[0]}x{b[1]}"] = resume_case(a, b)
    return run_cases(cases)
