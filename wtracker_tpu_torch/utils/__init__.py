"""Host utilities of the port (configuration persistence, device selection)."""
