"""Download and convert model weights for the port; counterpart of
``refiners_tpu/conversion/cli.py`` (``get_weights``).

    python -m refiners_tpu_torch.conversion.cli                  # list
    python -m refiners_tpu_torch.conversion.cli sd15.unet        # a hub entry
    python -m refiners_tpu_torch.conversion.cli --from-file unet.safetensors \
        --format sd15.unet/diffusers -o sd15_unet.safetensors

Two conversion paths:
- hub entries (`REGISTRY`): refiners-layout checkpoints published on the HF
  hub, checked against the port's models and written under
  ``$REFINERS_TPU_WEIGHTS/converted_torch/`` (``~/.cache/refiners_tpu`` by
  default);
- upstream files (``--from-file`` + ``--format``): local diffusers /
  original-LDM / transformers / tencent checkpoints, converted through the
  per-model recipes (`upstream_recipes` / `upstream_converters`) into the
  refiners key layout in torch's tensor layouts, which the port loads as
  they are (``load_state_dict(..., strict=True)``).
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

from refiners_tpu_torch.conversion.models.registry import REGISTRY, upstream_converters, upstream_recipes


def _convert_upstream(spec: str, src: Path, out: Path | None) -> Path:
    from refiners_tpu_torch.fluxion.utils import load_from_safetensors, save_to_safetensors

    state = dict(load_from_safetensors(src))
    recipes = upstream_recipes()
    if spec in recipes:
        converted = recipes[spec].translate(state)
    else:
        converted = upstream_converters()[spec](state)
    out = out or src.with_suffix(".converted.safetensors")
    save_to_safetensors(out, converted)
    return out


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m refiners_tpu_torch.conversion.cli",
        description="Download and convert model weights for refiners_tpu_torch (torch layouts).",
    )
    parser.add_argument("models", nargs="*", help="model names to convert (default: list available)")
    parser.add_argument("--output", "-o", default=None, help="output path (single model only)")
    parser.add_argument("--all", action="store_true", help="convert every registered model")
    parser.add_argument("--from-file", default=None, help="convert a local upstream checkpoint instead")
    parser.add_argument(
        "--format",
        default=None,
        help="upstream format spec '<model>/<format>' (with --from-file); run with no args to list",
    )
    args = parser.parse_args(argv)

    if args.from_file:
        if not args.format:
            print("--from-file requires --format '<model>/<format>'", file=sys.stderr)
            return 1
        known = sorted(set(upstream_recipes()) | set(upstream_converters()))
        if args.format not in known:
            print(f"unknown format {args.format!r}; known: {', '.join(known)}", file=sys.stderr)
            return 1
        # a converter's own KeyError (a key the file lacks) propagates, naming the key
        out = _convert_upstream(args.format, Path(args.from_file), Path(args.output) if args.output else None)
        print(f"{args.from_file} → {out}")
        return 0

    names = list(REGISTRY) if args.all else args.models
    if not names:
        print("available models (hub):")
        for name, entry in REGISTRY.items():
            print(f"  {name:36s} {entry.description}")
        print("upstream formats (--from-file FILE --format SPEC):")
        for spec in sorted(set(upstream_recipes()) | set(upstream_converters())):
            print(f"  {spec}")
        from refiners_tpu_torch.conversion.models.registry import control_lora_hub, lora_hub

        print("loras (download-only, runtime-loaded):")
        for name, hub in lora_hub().items():
            print(f"  {name:36s} {hub.repo_id}/{hub.filename}")
        print("control-loras:")
        for name, hub in control_lora_hub().items():
            print(f"  {name:36s} {hub.repo_id}/{hub.filename}")
        return 0

    for name in names:
        if name not in REGISTRY:
            print(f"unknown model {name!r}; run with no arguments to list", file=sys.stderr)
            return 1
        out = REGISTRY[name].convert(args.output if len(names) == 1 else None)
        print(f"{name} → {out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
