"""Detector (YOLOv8) and movement predictor (ResMLP) modules."""
