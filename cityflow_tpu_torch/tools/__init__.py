"""Command-line tools: gridgen (grid roadnet generator) and bench."""
