"""Scene ingest: COLMAP / Blender readers, cameras, PLY interchange (host-side numpy)."""
