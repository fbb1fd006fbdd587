"""The port's public ops: a counterpart of every name the JAX package's
``ops`` exports. ``ctc_nll_cuda`` and ``ctc2d_nll_markov_cuda`` are the
losses on the hand-written CUDA kernels (``csrc/ctc.cu``, ``csrc/ctc2d.cu``),
where the JAX package exports its Pallas losses; ``ctc_loss`` and
``ctc2d_loss_markov`` take them for a CUDA tensor."""

from .ccl import connected_components, extract_regions, regions_to_quads, unclip_distance_for
from .ctc import ctc_beam_decode, ctc_greedy_decode, ctc_loss, ctc_nll_cuda
from .ctc2d import (
    ctc2d_greedy_decode,
    ctc2d_loss_independent,
    ctc2d_loss_markov,
    ctc2d_nll_markov_cuda,
    ctc2d_viterbi_height_decode,
    fuse_heights,
)
from .gt_maps import make_detection_gt, pad_polygons
from .image import (
    augment_images,
    augment_resize_with_aspect_pad,
    crop_resize_boxes,
    normalize,
    rectify_quads,
    rectify_quads_mxu,
    resize_bilinear,
    resize_matrix,
    resize_with_aspect_pad,
    rotate_crops,
    warp_bilinear,
)
from .losses import balanced_bce_loss, dice_loss, masked_l1_loss
from .precision import cast_floats

__all__ = [
    "connected_components",
    "extract_regions",
    "regions_to_quads",
    "unclip_distance_for",
    "ctc_beam_decode",
    "ctc_greedy_decode",
    "ctc_loss",
    "ctc2d_greedy_decode",
    "ctc2d_loss_independent",
    "ctc2d_loss_markov",
    "ctc2d_viterbi_height_decode",
    "fuse_heights",
    "make_detection_gt",
    "pad_polygons",
    "augment_images",
    "augment_resize_with_aspect_pad",
    "crop_resize_boxes",
    "normalize",
    "rectify_quads",
    "rectify_quads_mxu",
    "resize_bilinear",
    "resize_matrix",
    "resize_with_aspect_pad",
    "rotate_crops",
    "warp_bilinear",
    "balanced_bce_loss",
    "dice_loss",
    "masked_l1_loss",
    "ctc_nll_cuda",
    "ctc2d_nll_markov_cuda",
    "cast_floats",
]
