"""Roofline of the dry-run records (counterpart of
``repro.launch.roofline``).

For every (arch x shape x mesh) record of ``launch.dryrun``:

    compute term    = FLOPs_per_device / peak FLOP/s
    memory term     = bytes_accessed_per_device / HBM rate
    collective term = collective_bytes_per_device / link rate

with the peaks as arguments, by default the H100's from ``core.h100``:
989 TFLOP/s dense bf16, 3.35 TB/s HBM and NVLink 4's 450 GB/s in one
direction.  A mesh record's collective bytes are ``launch.collectives``'
count of what its step moves between mesh positions, over the mesh's
devices (``collective_traced``; a detector's is every param's gradient
sum over its data shards); one card's record has none and takes a zero
collective term.
MODEL_FLOPS is JAX's, term for term: 6*N(active)*tokens (train),
2*N*tokens (prefill), 2*N*batch (decode), and for the detectors the
dense-equivalent 2 (6 to train) * params * (H/32 * W/32) * batch; the
roofline fraction is MODEL_FLOPS at peak over the step's largest term.
Every row states the cell's dtype: the fp32 detector cells read against
the bf16 peak, as in JAX.

``bytes_accessed`` is the pre-fusion operand and result traffic of every
aten op, an upper bound on what the card's HBM moves, so the memory term
is pessimistic, as JAX's is.
"""
from __future__ import annotations

import argparse
import json
import math
import pathlib

from repro_torch.core import h100
from repro_torch.launch.dryrun import RESULTS_DIR
from repro_torch.models import registry as reg
from repro_torch.models.resnet_dcn import ResNetDCNConfig

CARD_BYTES = 80e9        # "80 GB": a cell fits one card if its peak does


def _model_flops_per_device(arch, shape_name: str, chips: int) -> float:
    cfg = arch.config
    shape = arch.shapes[shape_name]
    if isinstance(cfg, ResNetDCNConfig):
        # conv backbone: a dense-equivalent estimate, 2 * params * cells
        from repro_torch.launch.steps import arch_param_count
        n = arch_param_count(arch)
        cells = (cfg.img_size // 32) ** 2
        mult = 6 if shape.kind == "train_det" else 2
        return mult * n * cells * shape.global_batch / chips
    n_active = cfg.active_param_count()
    if shape.kind == "train":
        toks = shape.global_batch * shape.seq_len
        return 6 * n_active * toks / chips
    if shape.kind == "prefill":
        toks = shape.global_batch * shape.seq_len
        return 2 * n_active * toks / chips
    if shape.kind == "decode":
        return 2 * n_active * shape.global_batch / chips
    raise ValueError(shape.kind)


def analyze_cell(rec: dict, *, peak_flops: float = h100.PEAK_BF16_FLOPS,
                 hbm_bw: float = h100.PEAK_HBM_BYTES_PER_S,
                 link_bw: float = h100.NVLINK_BYTES_PER_S,
                 arch=None) -> dict:
    """One row of the roofline from a dry-run record."""
    if "error" in rec:
        return {"arch": rec["arch"], "shape": rec["shape"],
                "mesh": rec["mesh"], "error": rec["error"]}
    arch = arch or reg.get(rec["arch"])
    chips = math.prod(rec["mesh_shape"])
    flops = rec.get("flops_per_device", float("nan"))
    hbm_bytes = rec.get("bytes_accessed_per_device", float("nan"))
    coll = rec.get("collective_bytes")
    coll_bytes = 0 if coll is None else coll
    compute_s = flops / peak_flops
    memory_s = hbm_bytes / hbm_bw
    collective_s = coll_bytes / link_bw
    terms = {"compute": compute_s, "memory": memory_s,
             "collective": collective_s}
    dominant = max(terms, key=lambda k: terms[k])
    model_flops = _model_flops_per_device(arch, rec["shape"], chips)
    step_s = max(terms.values())
    peak = rec.get("peak_live_bytes")
    return {
        "arch": rec["arch"], "shape": rec["shape"], "mesh": rec["mesh"],
        "chips": chips, "dtype": rec.get("dtype"),
        "params": rec.get("params"),
        "flops_per_device": flops,
        "hbm_bytes_per_device": hbm_bytes,
        "collective_bytes_per_device": coll_bytes,
        "collective_traced": coll is not None,
        "compute_s": compute_s, "memory_s": memory_s,
        "collective_s": collective_s,
        "dominant": dominant,
        "roofline_ms": step_s * 1e3,
        "model_flops_per_device": model_flops,
        "model_over_counted": model_flops / flops if flops else float("nan"),
        # useful FLOPs at peak over the step's bounding term
        "roofline_fraction": (model_flops / peak_flops) / step_s
        if step_s > 0 else float("nan"),
        "argument_bytes": rec.get("argument_bytes"),
        "peak_live_bytes": peak,
        "fits_card": None if peak is None else peak <= CARD_BYTES,
    }


def load_all(mesh: str | None = "card",
             results_dir: pathlib.Path | str | None = None,
             **peaks) -> list[dict]:
    """Rows of every record in ``results_dir`` (of ``mesh``; None: all)."""
    out = []
    for p in sorted(pathlib.Path(results_dir or RESULTS_DIR).glob("*.json")):
        if p.name == "roofline.json":
            continue
        rec = json.loads(p.read_text())
        if mesh is not None and rec.get("mesh") != mesh:
            continue
        out.append(analyze_cell(rec, **peaks))
    return out


def _gb(v) -> str:
    return "" if v is None else f"{v / 1e9:.2f}"


def markdown_table(rows: list[dict]) -> str:
    hdr = ("| arch | shape | mesh | dtype | params (B) | args GB/device | "
           "peak GB | fits 80 GB | compute ms | memory ms | collective ms "
           "| dominant | MODEL/counted | roofline ms | roofline frac |\n"
           "|---|---|---|---|---|---|---|---|---|---|---|---|---|---|---|")
    lines = [hdr]
    for r in rows:
        if "error" in r:
            lines.append(f"| {r['arch']} | {r['shape']} | {r['mesh']} | "
                         f"ERROR: {r['error'][:40]} |" + " |" * 11)
            continue
        fits = {None: "", True: "yes", False: "no"}[r["fits_card"]]
        coll = f"{r['collective_s'] * 1e3:.3f}" if r["collective_traced"] \
            else "not traced"
        lines.append(
            f"| {r['arch']} | {r['shape']} | {r['mesh']} | {r['dtype']} "
            f"| {r['params'] / 1e9:.2f} | {_gb(r['argument_bytes'])} "
            f"| {_gb(r['peak_live_bytes'])} | {fits} "
            f"| {r['compute_s'] * 1e3:.3f} | {r['memory_s'] * 1e3:.3f} "
            f"| {coll} | **{r['dominant']}** "
            f"| {r['model_over_counted']:.2f} | {r['roofline_ms']:.3f} "
            f"| {r['roofline_fraction']:.3f} |")
    return "\n".join(lines)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--mesh", default="card",
                    help="card | single | multi | all")
    ap.add_argument("--out", help="also write the table to this file")
    ap.add_argument("--dir", default=None,
                    help=f"dry-run records (default {RESULTS_DIR})")
    args = ap.parse_args(argv)
    rows = load_all(None if args.mesh == "all" else args.mesh, args.dir)
    md = markdown_table(rows)
    print(md)
    if args.out:
        pathlib.Path(args.out).write_text(md + "\n")
    (pathlib.Path(args.dir or RESULTS_DIR) / "roofline.json").write_text(
        json.dumps(rows, indent=1))


if __name__ == "__main__":
    main()
