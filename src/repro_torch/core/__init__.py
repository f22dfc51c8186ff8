"""VP format core: formats, FXP grid, FXP->VP conversion, packed words."""
