"""Live loops of the port: the realtime cosmic web and the precision viewer."""
