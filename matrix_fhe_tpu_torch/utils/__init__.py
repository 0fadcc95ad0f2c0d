"""Debug and measurement helpers of the port."""
