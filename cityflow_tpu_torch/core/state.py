"""Constants shared by the ring step: the int32 sentinel and the overflow
bit flags (the JAX package's core/state.py keeps the same values)."""

INT_MAX = 2**31 - 1

# overflow bit flags
OV_SLOTS = 1        # a ring (or the vehicle pool) is full
OV_LINK_TABLE = 2   # more vehicles on one lanelink than its ring holds
OV_HOPS = 4         # a vehicle crossed more drivables in a step than bounded
OV_REMOVE = 8       # more removals / transfers in one step than bounded
