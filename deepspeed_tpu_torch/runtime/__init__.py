"""Training runtime: engine, precision, schedules, data loading."""
