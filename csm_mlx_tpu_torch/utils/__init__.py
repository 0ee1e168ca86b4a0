"""Host-side utilities: audio I/O and resampling."""
