"""Bit-exact std::mt19937 + generate_canonical<double> reproduction.

The reference's entire RNG is ONE default-seeded std::mt19937 shared by
every call site (src/rtweekend.h:25-29 of the reference). Its scene
generator (src/main.cpp:17-43) is therefore a deterministic function of
that stream — reproducing it here pins the EXACT cover-scene layout the
reference's committed golden image (image.ppm) was rendered from,
which is what makes per-pixel golden comparison meaningful (pixel
differences then come from Monte-Carlo sampling noise only, not from a
different random sphere layout).

- `MT19937`: the standard Mersenne Twister (init_genrand(5489), the
  std::mt19937 default seed) — word-exact vs libstdc++/MSVC.
- `canonical()`: uniform_real_distribution<double>(0,1) as both libstdc++
  and the MSVC STL implement it for a 32-bit engine: two words, first
  draw in the LOW bits — val = (w0 + w1*2^32) / 2^64.

The one reference behavior that is NOT pinned by the standard is argument
evaluation ORDER inside expressions like `point3(a + 0.9*rd(), 0.2,
b + 0.9*rd())` (unspecified in C++). scene.make_cover_scene_reference
exposes the order as a parameter; the golden test locks in the order that
matches the committed image (empirically: MSVC's right-to-left).
"""

from __future__ import annotations

N, M = 624, 397
MATRIX_A = 0x9908B0DF
UPPER_MASK = 0x80000000
LOWER_MASK = 0x7FFFFFFF
MASK32 = 0xFFFFFFFF


class MT19937:
    """std::mt19937 (32-bit Mersenne Twister), default seed 5489."""

    def __init__(self, seed: int = 5489):
        mt = [0] * N
        mt[0] = seed & MASK32
        for i in range(1, N):
            mt[i] = (1812433253 * (mt[i - 1] ^ (mt[i - 1] >> 30)) + i) & MASK32
        self.mt = mt
        self.mti = N

    def _twist(self) -> None:
        mt = self.mt
        for i in range(N):
            y = (mt[i] & UPPER_MASK) | (mt[(i + 1) % N] & LOWER_MASK)
            v = mt[(i + M) % N] ^ (y >> 1)
            if y & 1:
                v ^= MATRIX_A
            mt[i] = v
        self.mti = 0

    def next_u32(self) -> int:
        if self.mti >= N:
            self._twist()
        y = self.mt[self.mti]
        self.mti += 1
        y ^= y >> 11
        y ^= (y << 7) & 0x9D2C5680
        y ^= (y << 15) & 0xEFC60000
        y ^= y >> 18
        return y & MASK32

    def canonical(self) -> float:
        """uniform_real_distribution<double>(0,1)(gen): two 32-bit words,
        first word in the low bits (libstdc++ generate_canonical and the
        MSVC _Nrand_impl agree on this for a 32-bit engine)."""
        w0 = self.next_u32()
        w1 = self.next_u32()
        return (float(w0) + float(w1) * 4294967296.0) / 18446744073709551616.0

    def uniform(self, lo: float, hi: float) -> float:
        """random_double(min, max) (src/rtweekend.h:31-34)."""
        return lo + (hi - lo) * self.canonical()
