"""Post-processing utilities of the port."""
