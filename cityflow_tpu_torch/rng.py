"""Bit-exact std::mt19937 replica (host side, numpy).

The reference engine owns a single ``std::mt19937 rnd`` seeded from config
(reference: engine.cpp:54-55). All draws happen on the main thread in
deterministic order (SURVEY.md section 2.4), so the whole stream can be
replayed on the host to precompute spawn priorities / thread indices / first
lane choices.

std::mt19937 state init (C++ standard, 26.5.3.2):
    x[0] = seed
    x[i] = 1812433253 * (x[i-1] ^ (x[i-1] >> 30)) + i   (mod 2^32)
Generation: standard MT19937 twist + tempering.
"""

import numpy as np

_N = 624
_M = 397
_MATRIX_A = np.uint32(0x9908B0DF)
_UPPER_MASK = np.uint32(0x80000000)
_LOWER_MASK = np.uint32(0x7FFFFFFF)


class MT19937:
    """Replays the reference's std::mt19937 stream."""

    def __init__(self, seed: int = 5489):
        self.seed(seed)

    def seed(self, seed: int) -> None:
        st = np.empty(_N, dtype=np.uint64)
        st[0] = np.uint64(seed & 0xFFFFFFFF)
        for i in range(1, _N):
            prev = st[i - 1]
            st[i] = (np.uint64(1812433253) * (prev ^ (prev >> np.uint64(30))) + np.uint64(i)) & np.uint64(0xFFFFFFFF)
        self._state = st.astype(np.uint32)
        self._pos = _N  # force twist on first draw

    def _twist(self) -> None:
        # The twist reads already-updated entries for i >= N-M, so vectorize in
        # dependency-safe chunks: [0,227), [227,454), [454,623), then 623.
        old = self._state
        new = np.empty_like(old)

        def tw(xu, xl, base):
            x = (xu & _UPPER_MASK) | (xl & _LOWER_MASK)
            return base ^ (x >> np.uint32(1)) ^ np.where(
                (x & np.uint32(1)).astype(bool), _MATRIX_A, np.uint32(0))

        k = _N - _M  # 227
        new[0:k] = tw(old[0:k], old[1:k + 1], old[_M:_N])
        new[k:2 * k] = tw(old[k:2 * k], old[k + 1:2 * k + 1], new[0:k])
        new[2 * k:_N - 1] = tw(old[2 * k:_N - 1], old[2 * k + 1:_N], new[k:_N - 1 - k])
        new[_N - 1] = tw(old[_N - 1:_N], new[0:1], new[_M - 1:_M])[0]
        self._state = new
        self._pos = 0

    def draw_block(self, n: int) -> np.ndarray:
        """Draw n uint32 values."""
        out = np.empty(n, dtype=np.uint32)
        filled = 0
        while filled < n:
            if self._pos >= _N:
                self._twist()
            take = min(n - filled, _N - self._pos)
            y = self._state[self._pos:self._pos + take].copy()
            # tempering
            y ^= y >> np.uint32(11)
            y ^= (y << np.uint32(7)) & np.uint32(0x9D2C5680)
            y ^= (y << np.uint32(15)) & np.uint32(0xEFC60000)
            y ^= y >> np.uint32(18)
            out[filled:filled + take] = y
            self._pos += take
            filled += take
        return out

    def __call__(self) -> int:
        return int(self.draw_block(1)[0])

    # ---- state save/restore (for Archive parity with mt19937 serialization) ----
    def get_state(self):
        return (self._state.copy(), self._pos)

    def set_state(self, state) -> None:
        self._state = state[0].copy()
        self._pos = state[1]

    def serialize(self) -> str:
        """Match the libstdc++ ``operator<<`` text format: 624 state words then
        the read position, space separated (reference: archive.cpp:161-165
        serializes the engine RNG with the stream operator)."""
        words = [str(int(w)) for w in self._state]
        words.append(str(int(self._pos)))
        return " ".join(words)

    @classmethod
    def deserialize(cls, text: str) -> "MT19937":
        parts = text.split()
        rng = cls.__new__(cls)
        rng._state = np.array([int(p) for p in parts[:_N]], dtype=np.uint32)
        rng._pos = int(parts[_N]) if len(parts) > _N else _N
        return rng
