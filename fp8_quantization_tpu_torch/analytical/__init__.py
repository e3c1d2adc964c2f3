"""The analytical SQNR study (BASELINE config 1)."""
