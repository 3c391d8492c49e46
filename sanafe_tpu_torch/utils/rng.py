"""Deterministic RNG replicas for hardware-noise parity.

The reference models reproduce recorded hardware noise with three stock
generators; bit-exact spike parity requires replaying the same sequences:

- glibc ``rand()`` (TYPE_3 additive feedback), used for the TrueNorth LFSR
  threshold noise (``src/models.cpp:745-760``; ``std::rand() & mask``).
- ``std::mt19937`` + libstdc++ ``uniform_real_distribution<double>(0,1)``,
  used for Poisson input spikes (``src/models.hpp:344-378``, fixed seed =
  input-unit instance number).
- A replayable noise file stream for Loihi LIF membrane noise
  (``src/models.cpp:578-651``) — no RNG, just masked integer replay
  (handled in the compiler).
"""

from __future__ import annotations


class GlibcRand:
    """glibc rand() TYPE_3 additive-feedback generator (seed default 1).

    Matches ``std::rand()`` with no ``srand`` call on glibc systems:
    state r[0..33] seeded per initstate(), outputs r[i] = (r[i-31] +
    r[i-3]) mod 2^32, reported >> 1.
    """

    def __init__(self, seed: int = 1):
        if seed == 0:
            seed = 1
        r = [0] * 34
        r[0] = seed & 0xFFFFFFFF
        for i in range(1, 31):
            # r[i] = (16807 * r[i-1]) % 2147483647 without overflow
            hi, lo = divmod(r[i - 1], 127773)
            word = 16807 * lo - 2836 * hi
            if word < 0:
                word += 2147483647
            r[i] = word
        for i in range(31, 34):
            r[i] = r[i - 31]
        self._r = r
        self._i = 34
        # discard first 310 outputs (glibc warm-up)
        for _ in range(310):
            self._advance()

    def _advance(self) -> int:
        r = self._r
        val = (r[self._i - 31] + r[self._i - 3]) & 0xFFFFFFFF
        r.append(val)
        self._i += 1
        # bound memory: keep only the trailing 34 entries
        if len(r) > 1024:
            del r[:-34]
            self._i = 34
        return val

    def next(self) -> int:
        return self._advance() >> 1

    def next_n(self, n: int) -> list[int]:
        return [self.next() for _ in range(n)]

    def next_batch(self, n: int):
        """n outputs as a uint32 numpy array (vectorized; the additive
        feedback r[i] = r[i-31] + r[i-3] advances in blocks of 3, whose
        in-block values depend only on already-computed entries)."""
        import numpy as np

        if n <= 0:
            return np.zeros(0, dtype=np.uint32)
        # Seed the buffer with 34 history entries (not 31) so the trailing
        # 34-entry live-state window is full even for n < 3 draws.
        buf = np.empty(34 + n, dtype=np.uint64)
        buf[:34] = np.asarray(self._r[self._i - 34 : self._i], dtype=np.uint64)
        filled = 34
        total = 34 + n
        while filled < total:
            end = min(filled + 3, total)
            buf[filled:end] = (
                buf[filled - 31 : end - 31] + buf[filled - 3 : end - 3]
            ) & np.uint64(0xFFFFFFFF)
            filled = end
        # retain the trailing window as the live state
        self._r = [int(v) for v in buf[-34:]]
        self._i = 34
        return (buf[34:] >> np.uint64(1)).astype(np.uint32)


class MT19937:
    """std::mt19937 (init_genrand integer seeding), 32-bit outputs."""

    N = 624
    M = 397
    MATRIX_A = 0x9908B0DF
    UPPER = 0x80000000
    LOWER = 0x7FFFFFFF

    def __init__(self, seed: int):
        mt = [0] * self.N
        mt[0] = seed & 0xFFFFFFFF
        for i in range(1, self.N):
            mt[i] = (
                1812433253 * (mt[i - 1] ^ (mt[i - 1] >> 30)) + i
            ) & 0xFFFFFFFF
        self._mt = mt
        self._index = self.N

    def _generate(self) -> None:
        mt = self._mt
        for i in range(self.N):
            y = (mt[i] & self.UPPER) | (mt[(i + 1) % self.N] & self.LOWER)
            mt[i] = mt[(i + self.M) % self.N] ^ (y >> 1)
            if y & 1:
                mt[i] ^= self.MATRIX_A
        self._index = 0

    def next_u32(self) -> int:
        if self._index >= self.N:
            self._generate()
        y = self._mt[self._index]
        self._index += 1
        y ^= y >> 11
        y ^= (y << 7) & 0x9D2C5680
        y ^= (y << 15) & 0xEFC60000
        y ^= y >> 18
        return y & 0xFFFFFFFF

    def uniform_real(self) -> float:
        """libstdc++ uniform_real_distribution<double>(0,1): two 32-bit
        draws via generate_canonical<double, 53> — (x0 + x1*2^32) / 2^64."""
        x0 = self.next_u32()
        x1 = self.next_u32()
        value = (x0 + x1 * 4294967296.0) / 18446744073709551616.0
        if value >= 1.0:
            value = 0.9999999999999999
        return value

    def _next_u32_batch(self, n: int):
        """n tempered 32-bit outputs as a numpy array (vectorized twist)."""
        import numpy as np

        out = np.empty(n, dtype=np.uint32)
        pos = 0
        while pos < n:
            if self._index >= self.N:
                self._generate_np()
            take = min(n - pos, self.N - self._index)
            block = np.asarray(
                self._mt[self._index : self._index + take], dtype=np.uint32
            )
            self._index += take
            y = block.copy()
            y ^= y >> np.uint32(11)
            y ^= (y << np.uint32(7)) & np.uint32(0x9D2C5680)
            y ^= (y << np.uint32(15)) & np.uint32(0xEFC60000)
            y ^= y >> np.uint32(18)
            out[pos : pos + take] = y
            pos += take
        return out

    def _generate_np(self) -> None:
        """Vectorized twist, identical to _generate: phase 1 reads only
        pre-twist state; phase 2 reads phase-1 results at i+M-N; the final
        element reads the new mt[0]."""
        import numpy as np

        mt = np.asarray(self._mt, dtype=np.uint32)
        N, M = self.N, self.M
        upper = np.uint32(self.UPPER)
        lower = np.uint32(self.LOWER)
        matrix = np.uint32(self.MATRIX_A)
        new = mt.copy()
        # phase 1: i in [0, N-M)
        y = (mt[: N - M] & upper) | (mt[1 : N - M + 1] & lower)
        new[: N - M] = mt[M:N] ^ (y >> np.uint32(1)) ^ (
            np.where(y & np.uint32(1), matrix, np.uint32(0))
        )
        # phase 2: i in [N-M, N-1), reading new[i+M-N] — advance in
        # (N-M)-wide sub-blocks so each block's dependencies are already
        # written (i - (N-M) chains through this phase's own outputs)
        start = N - M
        while start < N - 1:
            end = min(start + (N - M), N - 1)
            y = (mt[start:end] & upper) | (mt[start + 1 : end + 1] & lower)
            new[start:end] = new[start - (N - M) : end - (N - M)] ^ (
                y >> np.uint32(1)
            ) ^ np.where(y & np.uint32(1), matrix, np.uint32(0))
            start = end
        # final element: i = N-1, reading new[0]
        y_last = (mt[N - 1] & upper) | (new[0] & lower)
        last = new[M - 1] ^ (y_last >> np.uint32(1))
        if y_last & np.uint32(1):
            last ^= matrix
        new[N - 1] = last
        self._mt = [int(v) for v in new]
        self._index = 0

    def uniform_real_batch(self, n: int):
        """n uniform doubles, identical stream to uniform_real()."""
        import numpy as np

        draws = self._next_u32_batch(2 * n).astype(np.float64)
        value = (draws[0::2] + draws[1::2] * 4294967296.0) / (
            18446744073709551616.0
        )
        return np.minimum(value, 0.9999999999999999)


def mask_loihi_noise(raw: int, noise_bits: int = 7) -> int:
    """Apply the Loihi noise sign-extension quirk
    (src/models.cpp:629-651): sign bit is fixed at bit 8 (0x100) while
    random_mask tracks noise_bits."""
    sign_mask = 0x100
    random_mask = (1 << noise_bits) - 1
    value = raw & random_mask
    if raw & sign_mask:
        # Python ints are arbitrary-precision two's complement, so C's
        # `random_val |= ~random_mask` sign extension maps directly
        value |= ~random_mask
    return value
