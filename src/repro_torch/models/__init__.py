"""The model stack: layers, attention, MLP, worker fusion, blocks, model."""
