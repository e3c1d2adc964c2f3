"""Range estimators and the calibrate / evaluate loops."""
