"""Dense transformer serving path: layers, attention, MLP, model, weights."""
