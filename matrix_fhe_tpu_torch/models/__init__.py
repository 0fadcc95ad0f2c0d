"""The HE scheme: randomness, encoders and HEContext."""
