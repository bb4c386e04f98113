"""Host-side scenario compilation (roadnet/flow JSON -> numpy tables)."""
