"""Math, camera, SH and system utilities."""
