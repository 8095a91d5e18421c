"""Detector (YOLOv8) and movement predictor (ResMLP) modules."""

from wtracker_tpu_torch.models.resmlp import (
    RMLP,
    MlpBlock,
    MLPLayer,
    WormPredictor,
    load_predictor,
    load_torch_checkpoint,
    make_rmlp_predictor,
    save_predictor,
)
from wtracker_tpu_torch.models.yolov8 import (
    YoloV8,
    YoloV8Detector,
    decode_predictions,
    detect_top1,
    fuse_conv_bn,
    make_anchors,
)
from wtracker_tpu_torch.models.yolov8_int8 import (
    QuantizedYolo,
    detect_top1_int8,
    quantize_detector,
)

__all__ = [
    "RMLP", "MlpBlock", "MLPLayer", "WormPredictor",
    "load_predictor", "load_torch_checkpoint", "make_rmlp_predictor", "save_predictor",
    "YoloV8", "YoloV8Detector", "decode_predictions", "detect_top1", "fuse_conv_bn", "make_anchors",
    "QuantizedYolo", "detect_top1_int8", "quantize_detector",
]
