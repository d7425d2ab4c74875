"""The yolox-drone attention and fusion zoo, the counterpart of
``glsdet_tpu.models.variants`` (NCHW modules; weights from an explicit
``torch.Generator`` through ``layers.flax_init_``)."""

from glsdet_tpu_torch.models.variants.attention import (
    ConAugModule,
    MSCAM,
    NonLocalBlock,
    PatchConvNonLocal,
    PatchConvNonLocal44,
    PatchConvNonLocalAdapt,
    PatchNonLocal,
    PatchNonLocalQuad,
    SE,
    SEAttention,
    SEBlock,
    SEBlockFPN,
    SpatialAttention,
    VANAttention,
)
from glsdet_tpu_torch.models.variants.batchformer import (BatchFormer,
                                                          BatchFormerV2)
from glsdet_tpu_torch.models.variants.blocks import IdentityConv, ReverseFocus
from glsdet_tpu_torch.models.variants.cfp import (EVCBlock, LightMLPBlock,
                                                  LVCBlock)
from glsdet_tpu_torch.models.variants.dyhead import (
    DeformConv3x3,
    DyConv,
    DyHead,
    DyReLU,
    bilinear_gather,
    h_sigmoid,
)
from glsdet_tpu_torch.models.variants.ffa import FFA, pixel_shuffle_2x
from glsdet_tpu_torch.models.variants.ffa_model import FFA_STRIDES, FFAYoloBody
from glsdet_tpu_torch.models.variants.lsk import LSKAttention, LSKBlock
from glsdet_tpu_torch.models.variants.necks import (
    FeatureGroup,
    FeatureGroupFPN,
    cross_scale_concat,
)

__all__ = [
    "ConAugModule",
    "MSCAM",
    "NonLocalBlock",
    "PatchConvNonLocal",
    "PatchConvNonLocal44",
    "PatchConvNonLocalAdapt",
    "PatchNonLocal",
    "PatchNonLocalQuad",
    "SE",
    "SEAttention",
    "SEBlock",
    "SEBlockFPN",
    "SpatialAttention",
    "VANAttention",
    "BatchFormer",
    "BatchFormerV2",
    "IdentityConv",
    "ReverseFocus",
    "EVCBlock",
    "LightMLPBlock",
    "LVCBlock",
    "DeformConv3x3",
    "DyConv",
    "DyHead",
    "DyReLU",
    "bilinear_gather",
    "h_sigmoid",
    "FFA",
    "pixel_shuffle_2x",
    "FFA_STRIDES",
    "FFAYoloBody",
    "LSKAttention",
    "LSKBlock",
    "FeatureGroup",
    "FeatureGroupFPN",
    "cross_scale_concat",
]
