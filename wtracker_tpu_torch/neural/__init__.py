"""Training: configs and optimizers, datasets, the ResMLP trainer, the particle
swarm, and the YOLOv8 loss and full recipe."""
