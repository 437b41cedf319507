"""resnet50_dcn — the paper's own model (Sec. 4.1), as
``repro.configs.resnet50_dcn`` declares it.

* ``resnet50_dcn``         — lambda=0 baseline (unbounded offsets)
* ``resnet50_dcn_bounded`` — the Eq. 5-trained hardware-friendly model
                             (offset bound 2.0 -> RF = 7), served through
                             the fused kernel.
"""
from repro_torch.models.registry import ArchSpec, ShapeSpec
from repro_torch.models.resnet_dcn import ResNetDCNConfig

DET_SHAPES = {
    "train_det": ShapeSpec("train_det", 0, 128, note="512x512 synthetic COCO"),
    "infer_det": ShapeSpec("infer_det", 0, 256, note="batch inference"),
}

CONFIG = ResNetDCNConfig(
    name="resnet50_dcn",
    stage_sizes=(3, 4, 6, 3),
    widths=(256, 512, 1024, 2048),
    stem_width=64,
    num_dcn=12,
    offset_bound=None,
    num_classes=80,
    img_size=512,
)

CONFIG_BOUNDED = ResNetDCNConfig(
    name="resnet50_dcn_bounded",
    stage_sizes=(3, 4, 6, 3),
    widths=(256, 512, 1024, 2048),
    stem_width=64,
    num_dcn=12,
    offset_bound=2.0,
    num_classes=80,
    img_size=512,
)

ARCHS = {c.name: c for c in (CONFIG, CONFIG_BOUNDED)}

SPECS = {
    "resnet50_dcn": ArchSpec(
        name="resnet50_dcn", family="cnn", config=CONFIG,
        shapes=dict(DET_SHAPES),
        source="this paper, Sec. 4.1 (Faster R-CNN head simplified to a "
               "dense single-scale head)",
        notes="lambda=0 baseline: unbounded offsets -> the plain gather."),
    "resnet50_dcn_bounded": ArchSpec(
        name="resnet50_dcn_bounded", family="cnn", config=CONFIG_BOUNDED,
        shapes=dict(DET_SHAPES), source="this paper, Sec. 3.1/3.2",
        notes="Eq. 5-trained bound B=2 (RF=7): the fused kernels."),
}


def get(name: str) -> ResNetDCNConfig:
    try:
        return ARCHS[name]
    except KeyError:
        raise ValueError(f"unknown arch {name!r}; the port knows "
                         f"{sorted(ARCHS)}") from None
