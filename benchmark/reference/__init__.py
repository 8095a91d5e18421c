"""The plain reference of the benchmark's cells: the renderer, the YOLOv8
detector (float32, and its int8 or int4 fake-quantized form) and the
tracking loop's predictor and motor, in plain PyTorch and numpy.  It imports
nothing of the port and reads the checkpoint file itself; every tensor it
computes with is its own or an input that the benchmark made for both
sides."""
