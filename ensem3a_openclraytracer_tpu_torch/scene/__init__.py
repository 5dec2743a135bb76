"""Scene pipeline: OBJ import, ini config, materials, packing."""
