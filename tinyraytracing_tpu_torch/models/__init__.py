"""Scene, camera and procedural scenes."""
