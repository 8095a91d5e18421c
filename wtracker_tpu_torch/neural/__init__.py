"""Predictor-network configuration."""
