"""Image-quality metrics."""
