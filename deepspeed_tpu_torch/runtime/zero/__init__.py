"""ZeRO configuration (one card: stages 0-2 hold the full state)."""
