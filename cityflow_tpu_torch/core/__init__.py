"""The ring step and its speed-model helpers."""
