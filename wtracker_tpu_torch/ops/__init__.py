"""Image ops and the hand-written CUDA kernels with their plain versions."""

from wtracker_tpu_torch.ops.boxes import BoxFormat, box_iou, center, discretize, round_boxes, to_xywh, to_xyxy, to_yolo
from wtracker_tpu_torch.ops.image import crop_views, letterbox, replicate_pad, resize_bilinear
from wtracker_tpu_torch.ops.morphology import dilate, erode, largest_component_bbox, opening, worm_bboxes_batch
from wtracker_tpu_torch.ops.nms import batched_nms, nms
from wtracker_tpu_torch.ops.polyfit import fit_and_eval, jacobi_eigh, lstsq_minnorm, polyfit, polyval

__all__ = [
    "BoxFormat", "box_iou", "center", "discretize", "round_boxes", "to_xywh", "to_xyxy", "to_yolo",
    "crop_views", "letterbox", "replicate_pad", "resize_bilinear",
    "dilate", "erode", "largest_component_bbox", "opening", "worm_bboxes_batch",
    "batched_nms", "nms",
    "fit_and_eval", "jacobi_eigh", "lstsq_minnorm", "polyfit", "polyval",
]
