"""Applications (the voice chat's text hygiene, for now)."""
