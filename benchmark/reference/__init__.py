"""The plain reference a benchmark run is compared with (harmony.py)."""
