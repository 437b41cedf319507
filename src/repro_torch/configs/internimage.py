"""internimage_b_bounded — InternImage-B (arXiv:2211.05778, Table 1; the
official ``mask_rcnn_internimage_b_fpn_1x_coco.py``) as a detector of
this port: C = 112, depths 4/4/21/4, DCNv3 groups 7/14/28/56 (16
channels a group), kernel 3, MLP ratio 4, post-norm with layer scale,
LayerNorm eps 1e-6, offset scale 1.0, about 95 M parameters in the
backbone.

Two departures: the DCNv3 offsets are clamped to B = 2.0 (RF 7), the
paper's Eq. 5 applied to DCNv3, so each layer reads a bounded window;
and the Mask R-CNN FPN head is replaced by the dense single-scale head
of the ResNet-50-DCN detectors, on the last stage.
"""
from repro_torch.configs.resnet50_dcn import DET_SHAPES
from repro_torch.models.internimage import InternImageConfig
from repro_torch.models.registry import ArchSpec

CONFIG_BOUNDED = InternImageConfig(
    name="internimage_b_bounded",
    channels=112,
    depths=(4, 4, 21, 4),
    groups=(7, 14, 28, 56),
    kernel_size=3,
    mlp_ratio=4.0,
    offset_bound=2.0,
    num_classes=80,
    img_size=512,
)

ARCHS = {CONFIG_BOUNDED.name: CONFIG_BOUNDED}

SPECS = {
    "internimage_b_bounded": ArchSpec(
        name="internimage_b_bounded", family="cnn", config=CONFIG_BOUNDED,
        shapes=dict(DET_SHAPES),
        source="arXiv:2211.05778 Table 1 and the official "
               "mask_rcnn_internimage_b_fpn_1x_coco.py (dense single-scale "
               "head in place of Mask R-CNN's)",
        notes="DCNv3 offsets bounded at B=2 (RF=7): the dv3_ kernel; "
              "served on fp32_kernel only (no int8 calibration, no "
              "backward kernel)"),
}
