"""Closed-loop simulation: configs, motor, cycle engine, live video loop."""
