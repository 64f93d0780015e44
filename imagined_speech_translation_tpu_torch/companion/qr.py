"""Self-contained QR encoder for the device-page surfaces.

The reference app renders provisioning payloads (``WIFI:`` credentials,
pairing URLs) as QR codes on the companion's device page; this module is the
framework's renderer: ISO/IEC 18004 byte mode, error-correction level M,
versions 1-10 (up to 213 payload bytes), full 8-mask penalty selection.
Outputs a boolean module matrix plus SVG/ASCII renderers for the web UI and
terminal. Verified round-trip against OpenCV's ``QRCodeDetector`` in
``tests/test_companion_ui.py``.

No third-party QR dependency: GF(256) Reed-Solomon and BCH format/version
codes are implemented here.

A copy of ``imagined_speech_translation_tpu.companion.qr`` (it imports no
jax), so the port imports nothing of the JAX package; a test holds its code
to the original's.
"""

from __future__ import annotations

# --------------------------------------------------------------------------
# GF(256) tables (poly 0x11D)
_EXP = [0] * 512
_LOG = [0] * 256
_x = 1
for _i in range(255):
    _EXP[_i] = _x
    _LOG[_x] = _i
    _x <<= 1
    if _x & 0x100:
        _x ^= 0x11D
for _i in range(255, 512):
    _EXP[_i] = _EXP[_i - 255]


def _rs_generator(n_ec: int) -> list[int]:
    # product of (x - α^i); built lowest-degree-first, returned
    # highest-degree-first (leading 1) for the synthetic division below
    g = [1]
    for i in range(n_ec):
        ng = [0] * (len(g) + 1)
        for j, c in enumerate(g):
            ng[j] ^= _EXP[(_LOG[c] + i) % 255] if c else 0
            ng[j + 1] ^= c
        g = ng
    return g[::-1]


def _rs_encode(data: list[int], n_ec: int) -> list[int]:
    gen = _rs_generator(n_ec)
    rem = [0] * n_ec
    for byte in data:
        factor = byte ^ rem[0]
        rem = rem[1:] + [0]
        if factor:
            lf = _LOG[factor]
            for i in range(n_ec):
                rem[i] ^= _EXP[lf + _LOG[gen[i + 1]]] if gen[i + 1] else 0
    return rem


# --------------------------------------------------------------------------
# Level-M block structure per version: list of (n_blocks, data_codewords)
# groups + EC codewords per block (ISO 18004 table 9).
_BLOCKS_M = {
    1: ([(1, 16)], 10),
    2: ([(1, 28)], 16),
    3: ([(1, 44)], 26),
    4: ([(2, 32)], 18),
    5: ([(2, 43)], 24),
    6: ([(4, 27)], 16),
    7: ([(4, 31)], 18),
    8: ([(2, 38), (2, 39)], 22),
    9: ([(3, 36), (2, 37)], 22),
    10: ([(4, 43), (1, 44)], 26),
}
_REMAINDER_BITS = {1: 0, 2: 7, 3: 7, 4: 7, 5: 7, 6: 7, 7: 0, 8: 0, 9: 0, 10: 0}
_ALIGN = {
    1: [], 2: [6, 18], 3: [6, 22], 4: [6, 26], 5: [6, 30],
    6: [6, 34], 7: [6, 22, 38], 8: [6, 24, 42], 9: [6, 26, 46],
    10: [6, 28, 50],
}


def _data_capacity(version: int) -> int:
    groups, _ = _BLOCKS_M[version]
    return sum(n * k for n, k in groups)


def _pick_version(n_bytes: int) -> int:
    for v in range(1, 11):
        count_bits = 16 if v >= 10 else 8
        need_bits = 4 + count_bits + 8 * n_bytes
        if need_bits <= 8 * _data_capacity(v):
            return v
    raise ValueError(f"payload too large for version<=10 at level M: {n_bytes} bytes")


def _bitstream(payload: bytes, version: int) -> list[int]:
    cap = _data_capacity(version)
    bits: list[int] = []

    def put(val: int, n: int) -> None:
        for i in range(n - 1, -1, -1):
            bits.append((val >> i) & 1)

    put(0b0100, 4)  # byte mode
    put(len(payload), 16 if version >= 10 else 8)
    for b in payload:
        put(b, 8)
    # terminator, byte-align, pad codewords
    bits.extend([0] * min(4, 8 * cap - len(bits)))
    bits.extend([0] * (-len(bits) % 8))
    pads = (0xEC, 0x11)
    i = 0
    while len(bits) < 8 * cap:
        put(pads[i % 2], 8)
        i += 1
    return bits


def _codewords(payload: bytes, version: int) -> list[int]:
    bits = _bitstream(payload, version)
    data = [
        int("".join(map(str, bits[i : i + 8])), 2) for i in range(0, len(bits), 8)
    ]
    groups, n_ec = _BLOCKS_M[version]
    blocks: list[list[int]] = []
    pos = 0
    for n, k in groups:
        for _ in range(n):
            blocks.append(data[pos : pos + k])
            pos += k
    ec_blocks = [_rs_encode(b, n_ec) for b in blocks]
    out: list[int] = []
    for i in range(max(len(b) for b in blocks)):
        out.extend(b[i] for b in blocks if i < len(b))
    for i in range(n_ec):
        out.extend(b[i] for b in ec_blocks)
    return out


# --------------------------------------------------------------------------
# Matrix construction
def _place_function_patterns(version: int):
    size = 17 + 4 * version
    m = [[None] * size for _ in range(size)]  # None = free for data

    def finder(r0: int, c0: int) -> None:
        for r in range(-1, 8):
            for c in range(-1, 8):
                rr, cc = r0 + r, c0 + c
                if not (0 <= rr < size and 0 <= cc < size):
                    continue
                inside = 0 <= r <= 6 and 0 <= c <= 6
                ring = inside and (r in (0, 6) or c in (0, 6))
                core = inside and 2 <= r <= 4 and 2 <= c <= 4
                m[rr][cc] = 1 if (ring or core) else 0

    finder(0, 0)
    finder(0, size - 7)
    finder(size - 7, 0)
    # timing
    for i in range(8, size - 8):
        v = 1 if i % 2 == 0 else 0
        if m[6][i] is None:
            m[6][i] = v
        if m[i][6] is None:
            m[i][6] = v
    # alignment patterns
    centers = _ALIGN[version]
    for rc in centers:
        for cc_ in centers:
            # skip only the three finder-overlapping positions; centers on
            # the timing row/column legitimately overlay the timing pattern
            if (
                (rc < 9 and cc_ < 9)
                or (rc < 9 and cc_ > size - 10)
                or (rc > size - 10 and cc_ < 9)
            ):
                continue
            for dr in range(-2, 3):
                for dc in range(-2, 3):
                    m[rc + dr][cc_ + dc] = (
                        1 if max(abs(dr), abs(dc)) != 1 else 0
                    )
    # dark module
    m[size - 8][8] = 1
    # reserve format info areas
    for i in range(9):
        if m[8][i] is None:
            m[8][i] = 0
        if m[i][8] is None:
            m[i][8] = 0
    for i in range(8):
        if m[8][size - 1 - i] is None:
            m[8][size - 1 - i] = 0
        if m[size - 1 - i][8] is None:
            m[size - 1 - i][8] = 0
    # version info (v >= 7)
    if version >= 7:
        vbits = _version_bits(version)
        k = 0
        for c in range(6):
            for r in range(3):
                bit = (vbits >> k) & 1
                m[size - 11 + r][c] = bit
                m[c][size - 11 + r] = bit
                k += 1
    return m


def _version_bits(version: int) -> int:
    # BCH(18,6), generator 0x1F25
    d = version << 12
    for i in range(5, -1, -1):
        if d & (1 << (i + 12)):
            d ^= 0x1F25 << i
    return (version << 12) | d


def _format_bits(mask: int) -> int:
    # level M = 0b00
    data = (0b00 << 3) | mask
    d = data << 10
    for i in range(4, -1, -1):
        if d & (1 << (i + 10)):
            d ^= 0x537 << i
    return (((data << 10) | d) ^ 0x5412) & 0x7FFF


_MASKS = [
    lambda r, c: (r + c) % 2 == 0,
    lambda r, c: r % 2 == 0,
    lambda r, c: c % 3 == 0,
    lambda r, c: (r + c) % 3 == 0,
    lambda r, c: (r // 2 + c // 3) % 2 == 0,
    lambda r, c: (r * c) % 2 + (r * c) % 3 == 0,
    lambda r, c: ((r * c) % 2 + (r * c) % 3) % 2 == 0,
    lambda r, c: ((r + c) % 2 + (r * c) % 3) % 2 == 0,
]


def _place_data(m, codewords: list[int], remainder_bits: int):
    size = len(m)
    bits: list[int] = []
    for cw in codewords:
        bits.extend((cw >> i) & 1 for i in range(7, -1, -1))
    bits.extend([0] * remainder_bits)
    coords: list[tuple[int, int]] = []
    col = size - 1
    upward = True
    while col > 0:
        if col == 6:  # timing column is skipped entirely
            col -= 1
        rows = range(size - 1, -1, -1) if upward else range(size)
        for r in rows:
            for c in (col, col - 1):
                if m[r][c] is None:
                    coords.append((r, c))
        upward = not upward
        col -= 2
    assert len(coords) == len(bits), (len(coords), len(bits))
    for (r, c), b in zip(coords, bits):
        m[r][c] = b
    return coords


def _apply_format(m, mask: int) -> None:
    size = len(m)
    f = _format_bits(mask)
    bits = [(f >> i) & 1 for i in range(15)]  # bits[i] = bit i, 14 = MSB
    # copy 1 around the top-left finder: MSB (bit 14) at (8,0), then along
    # row 8 skipping the timing column, up column 8 to LSB at (0,8)
    top_left = [
        (8, 0), (8, 1), (8, 2), (8, 3), (8, 4), (8, 5), (8, 7), (8, 8),
        (7, 8), (5, 8), (4, 8), (3, 8), (2, 8), (1, 8), (0, 8),
    ]
    for (r, c), i in zip(top_left, range(14, -1, -1)):
        m[r][c] = bits[i]
    # copy 2: bits 14..8 down column 8 from the bottom edge (7 modules,
    # above the dark module), bits 7..0 along row 8 under the top-right
    # finder ending at the right edge
    for k in range(7):
        m[size - 1 - k][8] = bits[14 - k]
    for k in range(8):
        m[8][size - 8 + k] = bits[7 - k]
    m[size - 8][8] = 1  # dark module stays dark


def _penalty(m) -> int:
    size = len(m)
    total = 0
    # N1: runs of >=5
    for grid in (m, list(zip(*m))):
        for row in grid:
            run = 1
            for i in range(1, size):
                if row[i] == row[i - 1]:
                    run += 1
                else:
                    if run >= 5:
                        total += 3 + run - 5
                    run = 1
            if run >= 5:
                total += 3 + run - 5
    # N2: 2x2 blocks
    for r in range(size - 1):
        for c in range(size - 1):
            if m[r][c] == m[r][c + 1] == m[r + 1][c] == m[r + 1][c + 1]:
                total += 3
    # N3: finder-like pattern 1011101 with 4 light modules on a side
    pat1 = [1, 0, 1, 1, 1, 0, 1, 0, 0, 0, 0]
    pat2 = pat1[::-1]
    for grid in (m, list(zip(*m))):
        for row in grid:
            row = list(row)
            for i in range(size - 10):
                win = row[i : i + 11]
                if win == pat1 or win == pat2:
                    total += 40
    # N4: dark proportion
    dark = sum(sum(row) for row in m)
    pct = 100 * dark / (size * size)
    total += 10 * (int(abs(pct - 50)) // 5)
    return total


def encode(payload: str | bytes) -> list[list[int]]:
    """Encode ``payload`` → QR module matrix (1 = dark), best of 8 masks."""
    data = payload.encode("utf-8") if isinstance(payload, str) else bytes(payload)
    version = _pick_version(len(data))
    codewords = _codewords(data, version)

    base = _place_function_patterns(version)
    coords = _place_data(base, codewords, _REMAINDER_BITS[version])
    data_set = set(coords)

    best, best_pen = None, None
    for mask in range(8):
        m = [row[:] for row in base]
        for r, c in data_set:
            if _MASKS[mask](r, c):
                m[r][c] ^= 1
        _apply_format(m, mask)
        pen = _penalty(m)
        if best_pen is None or pen < best_pen:
            best, best_pen = m, pen
    return best


def to_svg(matrix: list[list[int]], module_px: int = 8, border: int = 4) -> str:
    """Render the module matrix as a standalone SVG string."""
    size = len(matrix)
    dim = (size + 2 * border) * module_px
    rects = []
    for r, row in enumerate(matrix):
        c = 0
        while c < size:
            if row[c]:
                c0 = c
                while c < size and row[c]:
                    c += 1
                rects.append(
                    f'<rect x="{(c0 + border) * module_px}" '
                    f'y="{(r + border) * module_px}" '
                    f'width="{(c - c0) * module_px}" height="{module_px}"/>'
                )
            else:
                c += 1
    body = "".join(rects)
    return (
        f'<svg xmlns="http://www.w3.org/2000/svg" width="{dim}" height="{dim}" '
        f'viewBox="0 0 {dim} {dim}"><rect width="{dim}" height="{dim}" '
        f'fill="#fff"/><g fill="#000">{body}</g></svg>'
    )


def to_ascii(matrix: list[list[int]]) -> str:
    """Terminal rendering (two chars per module)."""
    quiet = [[0] * (len(matrix) + 8) for _ in range(4)]
    padded = quiet + [[0] * 4 + row + [0] * 4 for row in matrix] + quiet
    return "\n".join(
        "".join("██" if v else "  " for v in row) for row in padded
    )
