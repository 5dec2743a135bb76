"""Scene generators, one module per generator named in a configuration's
``generator`` key, and the writer of the files ``Scene.load`` reads."""
