"""WebP lossy (VP8 key frames, RFC 6386) in numpy and the standard library,
bit-equal to libwebp's decode for ``cv2.imread`` / ``cv2.imdecode``.

* The boolean decoder (``_Bool``, RFC 6386 section 7, kept as libwebp keeps
  it: the range less one, the value with its unread bits below), the frame
  header (colour space and clamping bits, segments with their quantizer and
  filter deltas and map probabilities, the filter type, level, sharpness
  and mode/reference deltas, 1-8 token partitions, the quantizer indices and
  their deltas, coefficient probability updates, the skip probability), the
  per-macroblock modes (segment, skip, 16x16 or 4x4 luma, chroma) and the
  coefficient tokens with their contexts, dequantized as libwebp's
  ``VP8ParseQuant`` has it (the Y2 AC factor ``* 155 / 100``, at least 8;
  the chroma DC index at most 117).
* Reconstruction (section 12, 14): the inverse WHT and DCT of every block at
  once in numpy (the residual does not depend on the prediction), then the
  16x16, chroma and 4x4 predictions macroblock by macroblock on unfiltered
  pixels, with libwebp's borders (127 above the first row, 129 left of the
  first column, the DC modes without a missing edge, the top-right pixels of
  the rightmost macroblock repeated from the one above).
* The loop filters (section 15, libwebp's ``DoFilter``): simple or normal,
  macroblock and inner edges, each macroblock's level from its segment and
  mode. A macroblock's filtering reads pixels the filtering of the one to its
  left and the one above-right wrote, so macroblocks on one line
  ``x + 2y`` are filtered at once.
* libwebp's output to RGB, which RFC 6386 does not define: its "fancy"
  upsampling of the chroma planes (each output sample from the four nearest
  chroma samples, ``((N + 3 (H + V) + F + 8) >> 3 + N) >> 1``, edges
  repeated) and its fixed-point YUV -> RGB (``MultHi(v, c) = v * c >> 8``
  with 19077, 26149, 6419, 13320 and 33050, the offsets -14234, 8708 and
  -17685, then ``>> 6`` clipped to 0-255).

The constant tables below are RFC 6386's (the B-mode probabilities in
libwebp's order of the ten 4x4 modes); ``scripts/check_vp8_tables.py``
holds them against a libwebp library once. A stream that libwebp refuses
(not a displayable key frame, a partition past the data, tokens that read
past their partition's end) raises ``ValueError``.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

#: RFC 6386 section 13.5, ``default_coeff_probs`` [block type][band][context][token]
_COEF_PROBS = np.array([
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    253, 136, 254, 255, 228, 219, 128, 128, 128, 128, 128,
    189, 129, 242, 255, 227, 213, 255, 219, 128, 128, 128,
    106, 126, 227, 252, 214, 209, 255, 255, 128, 128, 128,
      1,  98, 248, 255, 236, 226, 255, 255, 128, 128, 128,
    181, 133, 238, 254, 221, 234, 255, 154, 128, 128, 128,
     78, 134, 202, 247, 198, 180, 255, 219, 128, 128, 128,
      1, 185, 249, 255, 243, 255, 128, 128, 128, 128, 128,
    184, 150, 247, 255, 236, 224, 128, 128, 128, 128, 128,
     77, 110, 216, 255, 236, 230, 128, 128, 128, 128, 128,
      1, 101, 251, 255, 241, 255, 128, 128, 128, 128, 128,
    170, 139, 241, 252, 236, 209, 255, 255, 128, 128, 128,
     37, 116, 196, 243, 228, 255, 255, 255, 128, 128, 128,
      1, 204, 254, 255, 245, 255, 128, 128, 128, 128, 128,
    207, 160, 250, 255, 238, 128, 128, 128, 128, 128, 128,
    102, 103, 231, 255, 211, 171, 128, 128, 128, 128, 128,
      1, 152, 252, 255, 240, 255, 128, 128, 128, 128, 128,
    177, 135, 243, 255, 234, 225, 128, 128, 128, 128, 128,
     80, 129, 211, 255, 194, 224, 128, 128, 128, 128, 128,
      1,   1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    246,   1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    255, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    198,  35, 237, 223, 193, 187, 162, 160, 145, 155,  62,
    131,  45, 198, 221, 172, 176, 220, 157, 252, 221,   1,
     68,  47, 146, 208, 149, 167, 221, 162, 255, 223, 128,
      1, 149, 241, 255, 221, 224, 255, 255, 128, 128, 128,
    184, 141, 234, 253, 222, 220, 255, 199, 128, 128, 128,
     81,  99, 181, 242, 176, 190, 249, 202, 255, 255, 128,
      1, 129, 232, 253, 214, 197, 242, 196, 255, 255, 128,
     99, 121, 210, 250, 201, 198, 255, 202, 128, 128, 128,
     23,  91, 163, 242, 170, 187, 247, 210, 255, 255, 128,
      1, 200, 246, 255, 234, 255, 128, 128, 128, 128, 128,
    109, 178, 241, 255, 231, 245, 255, 255, 128, 128, 128,
     44, 130, 201, 253, 205, 192, 255, 255, 128, 128, 128,
      1, 132, 239, 251, 219, 209, 255, 165, 128, 128, 128,
     94, 136, 225, 251, 218, 190, 255, 255, 128, 128, 128,
     22, 100, 174, 245, 186, 161, 255, 199, 128, 128, 128,
      1, 182, 249, 255, 232, 235, 128, 128, 128, 128, 128,
    124, 143, 241, 255, 227, 234, 128, 128, 128, 128, 128,
     35,  77, 181, 251, 193, 211, 255, 205, 128, 128, 128,
      1, 157, 247, 255, 236, 231, 255, 255, 128, 128, 128,
    121, 141, 235, 255, 225, 227, 255, 255, 128, 128, 128,
     45,  99, 188, 251, 195, 217, 255, 224, 128, 128, 128,
      1,   1, 251, 255, 213, 255, 128, 128, 128, 128, 128,
    203,   1, 248, 255, 255, 128, 128, 128, 128, 128, 128,
    137,   1, 177, 255, 224, 255, 128, 128, 128, 128, 128,
    253,   9, 248, 251, 207, 208, 255, 192, 128, 128, 128,
    175,  13, 224, 243, 193, 185, 249, 198, 255, 255, 128,
     73,  17, 171, 221, 161, 179, 236, 167, 255, 234, 128,
      1,  95, 247, 253, 212, 183, 255, 255, 128, 128, 128,
    239,  90, 244, 250, 211, 209, 255, 255, 128, 128, 128,
    155,  77, 195, 248, 188, 195, 255, 255, 128, 128, 128,
      1,  24, 239, 251, 218, 219, 255, 205, 128, 128, 128,
    201,  51, 219, 255, 196, 186, 128, 128, 128, 128, 128,
     69,  46, 190, 239, 201, 218, 255, 228, 128, 128, 128,
      1, 191, 251, 255, 255, 128, 128, 128, 128, 128, 128,
    223, 165, 249, 255, 213, 255, 128, 128, 128, 128, 128,
    141, 124, 248, 255, 255, 128, 128, 128, 128, 128, 128,
      1,  16, 248, 255, 255, 128, 128, 128, 128, 128, 128,
    190,  36, 230, 255, 236, 255, 128, 128, 128, 128, 128,
    149,   1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
      1, 226, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    247, 192, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    240, 128, 255, 128, 128, 128, 128, 128, 128, 128, 128,
      1, 134, 252, 255, 255, 128, 128, 128, 128, 128, 128,
    213,  62, 250, 255, 255, 128, 128, 128, 128, 128, 128,
     55,  93, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    202,  24, 213, 235, 186, 191, 220, 160, 240, 175, 255,
    126,  38, 182, 232, 169, 184, 228, 174, 255, 187, 128,
     61,  46, 138, 219, 151, 178, 240, 170, 255, 216, 128,
      1, 112, 230, 250, 199, 191, 247, 159, 255, 255, 128,
    166, 109, 228, 252, 211, 215, 255, 174, 128, 128, 128,
     39,  77, 162, 232, 172, 180, 245, 178, 255, 255, 128,
      1,  52, 220, 246, 198, 199, 249, 220, 255, 255, 128,
    124,  74, 191, 243, 183, 193, 250, 221, 255, 255, 128,
     24,  71, 130, 219, 154, 170, 243, 182, 255, 255, 128,
      1, 182, 225, 249, 219, 240, 255, 224, 128, 128, 128,
    149, 150, 226, 252, 216, 205, 255, 171, 128, 128, 128,
     28, 108, 170, 242, 183, 194, 254, 223, 255, 255, 128,
      1,  81, 230, 252, 204, 203, 255, 192, 128, 128, 128,
    123, 102, 209, 247, 188, 196, 255, 233, 128, 128, 128,
     20,  95, 153, 243, 164, 173, 255, 203, 128, 128, 128,
      1, 222, 248, 255, 216, 213, 128, 128, 128, 128, 128,
    168, 175, 246, 252, 235, 205, 255, 255, 128, 128, 128,
     47, 116, 215, 255, 211, 212, 255, 255, 128, 128, 128,
      1, 121, 236, 253, 212, 214, 255, 255, 128, 128, 128,
    141,  84, 213, 252, 201, 202, 255, 219, 128, 128, 128,
     42,  80, 160, 240, 162, 185, 255, 205, 128, 128, 128,
      1,   1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    244,   1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    238,   1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
], np.int64).reshape(4, 8, 3, 11)
#: RFC 6386 section 13.4, ``coeff_update_probs``
_COEF_UPDATE_PROBS = np.array([
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    176, 246, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    223, 241, 252, 255, 255, 255, 255, 255, 255, 255, 255,
    249, 253, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 244, 252, 255, 255, 255, 255, 255, 255, 255, 255,
    234, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    253, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 246, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    239, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 248, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    251, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    251, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 254, 253, 255, 254, 255, 255, 255, 255, 255, 255,
    250, 255, 254, 255, 254, 255, 255, 255, 255, 255, 255,
    254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    217, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    225, 252, 241, 253, 255, 255, 254, 255, 255, 255, 255,
    234, 250, 241, 250, 253, 255, 253, 254, 255, 255, 255,
    255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    223, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    238, 253, 254, 254, 255, 255, 255, 255, 255, 255, 255,
    255, 248, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    249, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 253, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    247, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    252, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    253, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 254, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    250, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    186, 251, 250, 255, 255, 255, 255, 255, 255, 255, 255,
    234, 251, 244, 254, 255, 255, 255, 255, 255, 255, 255,
    251, 251, 243, 253, 254, 255, 254, 255, 255, 255, 255,
    255, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    236, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    251, 253, 253, 254, 254, 255, 255, 255, 255, 255, 255,
    255, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    248, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    250, 254, 252, 254, 255, 255, 255, 255, 255, 255, 255,
    248, 254, 249, 253, 255, 255, 255, 255, 255, 255, 255,
    255, 253, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    246, 253, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    252, 254, 251, 254, 254, 255, 255, 255, 255, 255, 255,
    255, 254, 252, 255, 255, 255, 255, 255, 255, 255, 255,
    248, 254, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    253, 255, 254, 254, 255, 255, 255, 255, 255, 255, 255,
    255, 251, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    245, 251, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    253, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 251, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    252, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 252, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    249, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    250, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
], np.int64).reshape(4, 8, 3, 11)
#: RFC 6386 section 11.5, ``kf_bmode_probs`` [above][left], the modes in libwebp's order
_BMODE_PROBS = np.array([
    231, 120,  48,  89, 115, 113, 120, 152, 112,
    152, 179,  64, 126, 170, 118,  46,  70,  95,
    175,  69, 143,  80,  85,  82,  72, 155, 103,
     56,  58,  10, 171, 218, 189,  17,  13, 152,
    114,  26,  17, 163,  44, 195,  21,  10, 173,
    121,  24,  80, 195,  26,  62,  44,  64,  85,
    144,  71,  10,  38, 171, 213, 144,  34,  26,
    170,  46,  55,  19, 136, 160,  33, 206,  71,
     63,  20,   8, 114, 114, 208,  12,   9, 226,
     81,  40,  11,  96, 182,  84,  29,  16,  36,
    134, 183,  89, 137,  98, 101, 106, 165, 148,
     72, 187, 100, 130, 157, 111,  32,  75,  80,
     66, 102, 167,  99,  74,  62,  40, 234, 128,
     41,  53,   9, 178, 241, 141,  26,   8, 107,
     74,  43,  26, 146,  73, 166,  49,  23, 157,
     65,  38, 105, 160,  51,  52,  31, 115, 128,
    104,  79,  12,  27, 217, 255,  87,  17,   7,
     87,  68,  71,  44, 114,  51,  15, 186,  23,
     47,  41,  14, 110, 182, 183,  21,  17, 194,
     66,  45,  25, 102, 197, 189,  23,  18,  22,
     88,  88, 147, 150,  42,  46,  45, 196, 205,
     43,  97, 183, 117,  85,  38,  35, 179,  61,
     39,  53, 200,  87,  26,  21,  43, 232, 171,
     56,  34,  51, 104, 114, 102,  29,  93,  77,
     39,  28,  85, 171,  58, 165,  90,  98,  64,
     34,  22, 116, 206,  23,  34,  43, 166,  73,
    107,  54,  32,  26,  51,   1,  81,  43,  31,
     68,  25, 106,  22,  64, 171,  36, 225, 114,
     34,  19,  21, 102, 132, 188,  16,  76, 124,
     62,  18,  78,  95,  85,  57,  50,  48,  51,
    193, 101,  35, 159, 215, 111,  89,  46, 111,
     60, 148,  31, 172, 219, 228,  21,  18, 111,
    112, 113,  77,  85, 179, 255,  38, 120, 114,
     40,  42,   1, 196, 245, 209,  10,  25, 109,
     88,  43,  29, 140, 166, 213,  37,  43, 154,
     61,  63,  30, 155,  67,  45,  68,   1, 209,
    100,  80,   8,  43, 154,   1,  51,  26,  71,
    142,  78,  78,  16, 255, 128,  34, 197, 171,
     41,  40,   5, 102, 211, 183,   4,   1, 221,
     51,  50,  17, 168, 209, 192,  23,  25,  82,
    138,  31,  36, 171,  27, 166,  38,  44, 229,
     67,  87,  58, 169,  82, 115,  26,  59, 179,
     63,  59,  90, 180,  59, 166,  93,  73, 154,
     40,  40,  21, 116, 143, 209,  34,  39, 175,
     47,  15,  16, 183,  34, 223,  49,  45, 183,
     46,  17,  33, 183,   6,  98,  15,  32, 183,
     57,  46,  22,  24, 128,   1,  54,  17,  37,
     65,  32,  73, 115,  28, 128,  23, 128, 205,
     40,   3,   9, 115,  51, 192,  18,   6, 223,
     87,  37,   9, 115,  59,  77,  64,  21,  47,
    104,  55,  44, 218,   9,  54,  53, 130, 226,
     64,  90,  70, 205,  40,  41,  23,  26,  57,
     54,  57, 112, 184,   5,  41,  38, 166, 213,
     30,  34,  26, 133, 152, 116,  10,  32, 134,
     39,  19,  53, 221,  26, 114,  32,  73, 255,
     31,   9,  65, 234,   2,  15,   1, 118,  73,
     75,  32,  12,  51, 192, 255, 160,  43,  51,
     88,  31,  35,  67, 102,  85,  55, 186,  85,
     56,  21,  23, 111,  59, 205,  45,  37, 192,
     55,  38,  70, 124,  73, 102,   1,  34,  98,
    125,  98,  42,  88, 104,  85, 117, 175,  82,
     95,  84,  53,  89, 128, 100, 113, 101,  45,
     75,  79, 123,  47,  51, 128,  81, 171,   1,
     57,  17,   5,  71, 102,  57,  53,  41,  49,
     38,  33,  13, 121,  57,  73,  26,   1,  85,
     41,  10,  67, 138,  77, 110,  90,  47, 114,
    115,  21,   2,  10, 102, 255, 166,  23,   6,
    101,  29,  16,  10,  85, 128, 101, 196,  26,
     57,  18,  10, 102, 102, 213,  34,  20,  43,
    117,  20,  15,  36, 163, 128,  68,   1,  26,
    102,  61,  71,  37,  34,  53,  31, 243, 192,
     69,  60,  71,  38,  73, 119,  28, 222,  37,
     68,  45, 128,  34,   1,  47,  11, 245, 171,
     62,  17,  19,  70, 146,  85,  55,  62,  70,
     37,  43,  37, 154, 100, 163,  85, 160,   1,
     63,   9,  92, 136,  28,  64,  32, 201,  85,
     75,  15,   9,   9,  64, 255, 184, 119,  16,
     86,   6,  28,   5,  64, 255,  25, 248,   1,
     56,   8,  17, 132, 137, 255,  55, 116, 128,
     58,  15,  20,  82, 135,  57,  26, 121,  40,
    164,  50,  31, 137, 154, 133,  25,  35, 218,
     51, 103,  44, 131, 131, 123,  31,   6, 158,
     86,  40,  64, 135, 148, 224,  45, 183, 128,
     22,  26,  17, 131, 240, 154,  14,   1, 209,
     45,  16,  21,  91,  64, 222,   7,   1, 197,
     56,  21,  39, 155,  60, 138,  23, 102, 213,
     83,  12,  13,  54, 192, 255,  68,  47,  28,
     85,  26,  85,  85, 128, 128,  32, 146, 171,
     18,  11,   7,  63, 144, 171,   4,   4, 246,
     35,  27,  10, 146, 174, 171,  12,  26, 128,
    190,  80,  35,  99, 180,  80, 126,  54,  45,
     85, 126,  47,  87, 176,  51,  41,  20,  32,
    101,  75, 128, 139, 118, 146, 116, 128,  85,
     56,  41,  15, 176, 236,  85,  37,   9,  62,
     71,  30,  17, 119, 118, 255,  17,  18, 138,
    101,  38,  60, 138,  55,  70,  43,  26, 142,
    146,  36,  19,  30, 171, 255,  97,  27,  20,
    138,  45,  61,  62, 219,   1,  81, 188,  64,
     32,  41,  20, 117, 151, 142,  20,  21, 163,
    112,  19,  12,  61, 195, 128,  48,   4,  24,
], np.int64).reshape(10, 10, 9).tolist()
#: RFC 6386 section 14.1, ``dc_qlookup`` and ``ac_qlookup``
_DC_TABLE = np.array([
      4,   5,   6,   7,   8,   9,  10,  10,  11,  12,  13,  14,  15,  16,  17,  17,
     18,  19,  20,  20,  21,  21,  22,  22,  23,  23,  24,  25,  25,  26,  27,  28,
     29,  30,  31,  32,  33,  34,  35,  36,  37,  37,  38,  39,  40,  41,  42,  43,
     44,  45,  46,  46,  47,  48,  49,  50,  51,  52,  53,  54,  55,  56,  57,  58,
     59,  60,  61,  62,  63,  64,  65,  66,  67,  68,  69,  70,  71,  72,  73,  74,
     75,  76,  76,  77,  78,  79,  80,  81,  82,  83,  84,  85,  86,  87,  88,  89,
     91,  93,  95,  96,  98, 100, 101, 102, 104, 106, 108, 110, 112, 114, 116, 118,
    122, 124, 126, 128, 130, 132, 134, 136, 138, 140, 143, 145, 148, 151, 154, 157,
], np.int64)
_AC_TABLE = np.array([
      4,   5,   6,   7,   8,   9,  10,  11,  12,  13,  14,  15,  16,  17,  18,  19,
     20,  21,  22,  23,  24,  25,  26,  27,  28,  29,  30,  31,  32,  33,  34,  35,
     36,  37,  38,  39,  40,  41,  42,  43,  44,  45,  46,  47,  48,  49,  50,  51,
     52,  53,  54,  55,  56,  57,  58,  60,  62,  64,  66,  68,  70,  72,  74,  76,
     78,  80,  82,  84,  86,  88,  90,  92,  94,  96,  98, 100, 102, 104, 106, 108,
    110, 112, 114, 116, 119, 122, 125, 128, 131, 134, 137, 140, 143, 146, 149, 152,
    155, 158, 161, 164, 167, 170, 173, 177, 181, 185, 189, 193, 197, 201, 205, 209,
    213, 217, 221, 225, 229, 234, 239, 245, 249, 254, 259, 264, 269, 274, 279, 284,
], np.int64)

#: the order of the 16 coefficients of a block in the stream (raster index)
ZIGZAG = (0, 1, 4, 8, 5, 2, 3, 6, 9, 12, 13, 10, 7, 11, 14, 15)
#: coefficient position -> probability band (a 17th entry for the end)
BANDS = (0, 1, 2, 3, 6, 4, 5, 6, 6, 6, 6, 6, 6, 6, 6, 7, 0)
#: extra bits of the DCT_CAT3..6 tokens
_CATEGORIES = ((173, 148, 140), (176, 155, 140, 135), (180, 157, 141, 134, 130),
               (254, 254, 243, 230, 196, 177, 153, 140, 133, 130, 129))
# libwebp's mode numbers: 4x4 B_DC, B_TM, B_VE, B_HE, B_RD, B_VR, B_LD, B_VL,
# B_HD, B_HU; 16x16 and chroma DC 0, TM 1, V 2, H 3
_DC, _TM, _V, _H = 0, 1, 2, 3


class _Bool:
    """RFC 6386's boolean decoder over ``data[start:end]``, kept as libwebp
    keeps it: ``rng`` is the range less one, ``value`` holds the bits read
    so far and ``bits`` how many of them lie below the 8-bit window. Past the
    end it reads one zero byte and sets ``eof``."""

    __slots__ = ("data", "pos", "end", "value", "bits", "rng", "eof")

    def __init__(self, data: bytes, start: int, end: int):
        self.data, self.pos, self.end = data, start, end
        self.value, self.bits, self.rng, self.eof = 0, -8, 254, False
        self.load()

    def load(self) -> None:
        n = min(3, self.end - self.pos)
        if n > 0:
            self.value = (self.value << (8 * n)) | int.from_bytes(
                self.data[self.pos:self.pos + n], "big")
            self.pos += n
            self.bits += 8 * n
        elif not self.eof:
            self.value <<= 8
            self.bits += 8
            self.eof = True
        else:
            self.bits = 0

    def bit(self, prob: int) -> int:
        if self.bits < 0:
            self.load()
        rng = self.rng
        split = (rng * prob) >> 8
        if (self.value >> self.bits) > split:
            rng -= split
            self.value -= (split + 1) << self.bits
            bit = 1
        else:
            rng = split + 1
            bit = 0
        shift = 8 - rng.bit_length()
        self.rng = (rng << shift) - 1
        self.bits -= shift
        return bit

    def value_bits(self, n: int) -> int:
        v = 0
        for k in range(n - 1, -1, -1):
            v |= self.bit(128) << k
        return v

    def signed(self, n: int) -> int:
        v = self.value_bits(n)
        return -v if self.bit(128) else v


def _clip(v: int, top: int) -> int:
    return 0 if v < 0 else top if v > top else v


def _header(data: bytes, name: str):
    """The frame header -> (width, height, first partition decoder, the
    token partitions' decoders, header fields as a dict)."""
    if len(data) < 10:
        raise ValueError(f"{name}: WebP lossy frame header cut short")
    bits = data[0] | (data[1] << 8) | (data[2] << 16)
    if bits & 1:
        raise ValueError(f"{name}: WebP lossy data is not a key frame")
    if (bits >> 1) & 7 > 3 or not (bits >> 4) & 1:
        raise ValueError(f"{name}: WebP lossy frame of profile {(bits >> 1) & 7} or not shown")
    if data[3:6] != b"\x9d\x01\x2a":
        raise ValueError(f"{name}: WebP lossy frame without its start code")
    w = (data[6] | (data[7] << 8)) & 0x3FFF
    h = (data[8] | (data[9] << 8)) & 0x3FFF
    if not w or not h:
        raise ValueError(f"{name}: WebP lossy frame of no size")
    first = bits >> 5
    if first > len(data) - 10:
        raise ValueError(f"{name}: WebP lossy first partition runs past the data")
    br = _Bool(data, 10, 10 + first)
    br.bit(128)  # colour space
    br.bit(128)  # clamping type
    hdr = dict(use_segment=br.bit(128), update_map=0, absolute=1, quant=[0] * 4,
               strength=[0] * 4, seg_probs=[255, 255, 255])
    if hdr["use_segment"]:
        hdr["update_map"] = br.bit(128)
        if br.bit(128):
            hdr["absolute"] = br.bit(128)
            hdr["quant"] = [br.signed(7) if br.bit(128) else 0 for _ in range(4)]
            hdr["strength"] = [br.signed(6) if br.bit(128) else 0 for _ in range(4)]
        if hdr["update_map"]:
            hdr["seg_probs"] = [br.value_bits(8) if br.bit(128) else 255 for _ in range(3)]
    hdr["simple"] = br.bit(128)
    hdr["level"] = br.value_bits(6)
    hdr["sharpness"] = br.value_bits(3)
    ref, mode = [0] * 4, [0] * 4
    hdr["use_lf_delta"] = br.bit(128)
    if hdr["use_lf_delta"] and br.bit(128):
        ref = [br.signed(6) if br.bit(128) else 0 for _ in range(4)]
        mode = [br.signed(6) if br.bit(128) else 0 for _ in range(4)]
    hdr["ref_delta"], hdr["mode_delta"] = ref, mode
    if br.eof:
        raise ValueError(f"{name}: WebP lossy header runs past its partition")
    last = (1 << br.value_bits(2)) - 1
    start = 10 + first
    if len(data) - start < 3 * last:
        raise ValueError(f"{name}: WebP lossy partition sizes run past the data")
    at, left = start + 3 * last, len(data) - start - 3 * last
    parts = []
    for p in range(last):
        size = min(int.from_bytes(data[start + 3 * p:start + 3 * p + 3], "little"), left)
        parts.append(_Bool(data, at, at + size))
        at += size
        left -= size
    if at >= len(data):
        raise ValueError(f"{name}: WebP lossy token partitions run past the data")
    parts.append(_Bool(data, at, len(data)))
    base = br.value_bits(7)
    deltas = [br.signed(4) if br.bit(128) else 0 for _ in range(5)]
    hdr["dequant"] = _dequant(hdr, base, deltas)
    br.bit(128)  # refresh entropy probabilities: ignored for a key frame
    probs = _COEF_PROBS.copy()
    for t in range(4):
        for b in range(8):
            for c in range(3):
                for p in range(11):
                    if br.bit(int(_COEF_UPDATE_PROBS[t, b, c, p])):
                        probs[t, b, c, p] = br.value_bits(8)
    hdr["probs"] = probs
    hdr["skip_prob"] = br.value_bits(8) if br.bit(128) else None
    return w, h, br, parts, hdr


def _dequant(hdr: dict, base: int, d: List[int]) -> List[Tuple[int, ...]]:
    """libwebp's ``VP8ParseQuant``: for each segment (y1 dc, y1 ac, y2 dc,
    y2 ac, uv dc, uv ac)."""
    out = []
    for s in range(4):
        q = base
        if hdr["use_segment"]:
            q = hdr["quant"][s] + (0 if hdr["absolute"] else base)
        y2_ac = (int(_AC_TABLE[_clip(q + d[2], 127)]) * 101581) >> 16
        out.append((int(_DC_TABLE[_clip(q + d[0], 127)]), int(_AC_TABLE[_clip(q, 127)]),
                    int(_DC_TABLE[_clip(q + d[1], 127)]) * 2, max(y2_ac, 8),
                    int(_DC_TABLE[_clip(q + d[3], 117)]), int(_AC_TABLE[_clip(q + d[4], 127)])))
    return out


def _modes(br: _Bool, hdr: dict, top: list, left: list):
    """One macroblock's (segment, skip, 4x4 modes or None, 16x16 mode,
    chroma mode); ``top``/``left`` are the 4x4 mode contexts, updated."""
    seg = 0
    if hdr["update_map"]:
        p = hdr["seg_probs"]
        seg = br.bit(p[1]) if not br.bit(p[0]) else br.bit(p[2]) + 2
    skip = br.bit(hdr["skip_prob"]) if hdr["skip_prob"] is not None else 0
    sub = None
    if br.bit(145):
        ymode = (_TM if br.bit(128) else _H) if br.bit(156) else (_V if br.bit(163) else _DC)
        top[:] = [ymode] * 4
        left[:] = [ymode] * 4
    else:
        ymode = None
        sub = []
        for y in range(4):
            m = left[y]
            for x in range(4):
                p = _BMODE_PROBS[top[x]][m]
                if not br.bit(p[0]):
                    m = 0
                elif not br.bit(p[1]):
                    m = 1
                elif not br.bit(p[2]):
                    m = 2
                elif not br.bit(p[3]):
                    m = 3 if not br.bit(p[4]) else (4 if not br.bit(p[5]) else 5)
                elif not br.bit(p[6]):
                    m = 6
                elif not br.bit(p[7]):
                    m = 7
                else:
                    m = 8 if not br.bit(p[8]) else 9
                top[x] = m
                sub.append(m)
            left[y] = m
    uv = _DC if not br.bit(142) else _V if not br.bit(114) else _TM if br.bit(183) else _H
    return seg, skip, sub, ymode, uv


def _large(br: _Bool, p) -> int:
    """``GetLargeValue``: a token's value from DCT_TWO up."""
    if not br.bit(p[3]):
        return 2 if not br.bit(p[4]) else 3 + br.bit(p[5])
    if not br.bit(p[6]):
        if not br.bit(p[7]):
            return 5 + br.bit(159)
        return 7 + 2 * br.bit(165) + br.bit(145)
    b1 = br.bit(p[8])
    cat = 2 * b1 + br.bit(p[9 + b1])
    v = 0
    for prob in _CATEGORIES[cat]:
        v = 2 * v + br.bit(prob)
    return v + 3 + (8 << cat)


def _coeffs(br: _Bool, bands, ctx: int, dc: int, ac: int, n: int, out, at: int) -> int:
    """libwebp's ``GetCoeffs``: the tokens of one block from position ``n``
    into ``out[at:at + 16]`` (raster order, dequantized) -> the position after
    the last non-zero one (``n`` if none)."""
    p = bands[n][ctx]
    while n < 16:
        if not br.bit(p[0]):
            return n
        while not br.bit(p[1]):
            n += 1
            if n == 16:
                return 16
            p = bands[n][0]
        if not br.bit(p[2]):
            v = 1
            p = bands[n + 1][1]
        else:
            v = _large(br, p)
            p = bands[n + 1][2]
        out[at + ZIGZAG[n]] = (-v if br.bit(128) else v) * (ac if n else dc)
        n += 1
    return 16


def _wht(dc: np.ndarray) -> np.ndarray:
    """The inverse Walsh-Hadamard transform of (n, 16) Y2 blocks -> (n, 16)
    DC values of the 16 luma blocks (``TransformWHT``)."""
    i = dc.reshape(-1, 4, 4).astype(np.int64)
    a0, a1 = i[:, 0] + i[:, 3], i[:, 1] + i[:, 2]
    a2, a3 = i[:, 1] - i[:, 2], i[:, 0] - i[:, 3]
    t = np.stack([a0 + a1, a3 + a2, a0 - a1, a3 - a2], 1)  # rows of tmp
    d = t[:, :, 0] + 3
    b0, b1 = d + t[:, :, 3], t[:, :, 1] + t[:, :, 2]
    b2, b3 = t[:, :, 1] - t[:, :, 2], d - t[:, :, 3]
    return np.stack([b0 + b1, b3 + b2, b0 - b1, b3 - b2], 2).reshape(-1, 16) >> 3


def _mul1(a):
    return ((a * 20091) >> 16) + a


def _mul2(a):
    return (a * 35468) >> 16


def idct(coef: np.ndarray) -> np.ndarray:
    """``TransformOne`` of (n, 16) raster-order blocks -> (n, 4, 4) int64
    residuals (each ``(v + 4) >> 3``, added to the prediction then clipped)."""
    c = coef.reshape(-1, 4, 4).astype(np.int64)
    a, b = c[:, 0] + c[:, 2], c[:, 0] - c[:, 2]  # vertical pass, every column at once
    cc = _mul2(c[:, 1]) - _mul1(c[:, 3])
    d = _mul1(c[:, 1]) + _mul2(c[:, 3])
    t = np.stack([a + d, b + cc, b - cc, a - d], 1)  # t[:, k, col]
    dc = t[:, :, 0] + 4  # horizontal pass: row k from t[:, k, :]
    a, b = dc + t[:, :, 2], dc - t[:, :, 2]
    cc = _mul2(t[:, :, 1]) - _mul1(t[:, :, 3])
    d = _mul1(t[:, :, 1]) + _mul2(t[:, :, 3])
    return np.stack([a + d, b + cc, b - cc, a - d], 2) >> 3


def _parse(data: bytes, name: str):
    """Modes and dequantized coefficients of every macroblock."""
    w, h, br, parts, hdr = _header(data, name)
    mbw, mbh = (w + 15) >> 4, (h + 15) >> 4
    probs = hdr["probs"]
    # bands[t][n] = the (3, 11) probabilities of coefficient position n
    bands = [[[list(map(int, probs[t, BANDS[n], c])) for c in range(3)] for n in range(17)]
             for t in range(4)]
    n_mb = mbw * mbh
    coef = np.zeros((n_mb, 25 * 16), np.int64)  # 16 Y, 4 U, 4 V, then Y2
    info = []  # (segment, 4x4 modes or None, 16x16 mode, chroma mode, coded)
    top_modes = [[0] * 4 for _ in range(mbw)]
    top_nz = [0] * mbw  # bits 0-3 Y, 4-5 U, 6-7 V
    top_nz_dc = [0] * mbw
    dq = hdr["dequant"]
    for mby in range(mbh):
        left_modes = [0] * 4
        row = [_modes(br, hdr, top_modes[x], left_modes) for x in range(mbw)]
        if br.eof:
            raise ValueError(f"{name}: WebP lossy modes run past the first partition")
        tb = parts[mby % len(parts)]
        left_nz = left_nz_dc = 0
        for mbx, (seg, skip, sub, ymode, uv) in enumerate(row):
            k = mby * mbw + mbx
            buf = [0] * 400
            q = dq[seg]
            if not skip:
                if sub is None:
                    ctx = top_nz_dc[mbx] + left_nz_dc
                    nz = _coeffs(tb, bands[1], ctx, q[2], q[3], 0, buf, 384)
                    top_nz_dc[mbx] = left_nz_dc = int(nz > 0)
                    first, ac_bands = 1, bands[0]
                else:
                    first, ac_bands = 0, bands[3]
                tnz, lnz = top_nz[mbx] & 15, left_nz & 15
                new_t = [0] * 4
                new_l = [0] * 4
                for y in range(4):
                    lb = (lnz >> y) & 1
                    for x in range(4):
                        tbit = new_t[x] if y else (tnz >> x) & 1
                        nz = _coeffs(tb, ac_bands, lb + tbit, q[0], q[1], first, buf,
                                     16 * (4 * y + x))
                        lb = int(nz > first)
                        new_t[x] = lb
                    new_l[y] = lb
                t_bits = sum(b << i for i, b in enumerate(new_t))
                l_bits = sum(b << i for i, b in enumerate(new_l))
                for sh, at in ((4, 256), (6, 320)):  # U, V
                    tnz, lnz = (top_nz[mbx] >> sh) & 3, (left_nz >> sh) & 3
                    nt, nl = [0, 0], [0, 0]
                    for y in range(2):
                        lb = (lnz >> y) & 1
                        for x in range(2):
                            tbit = nt[x] if y else (tnz >> x) & 1
                            nz = _coeffs(tb, bands[2], lb + tbit, q[4], q[5], 0, buf,
                                         at + 16 * (2 * y + x))
                            lb = int(nz > 0)
                            nt[x] = lb
                        nl[y] = lb
                    t_bits |= (nt[0] | nt[1] << 1) << sh
                    l_bits |= (nl[0] | nl[1] << 1) << sh
                top_nz[mbx], left_nz = t_bits, l_bits
                coef[k] = buf
            else:
                top_nz[mbx] = left_nz = 0
                if sub is None:
                    top_nz_dc[mbx] = left_nz_dc = 0
            info.append((seg, sub, ymode, uv, skip))
            if tb.eof:
                raise ValueError(f"{name}: WebP lossy tokens run past their partition")
    return w, h, mbw, mbh, coef, info, hdr


def _residuals(coef: np.ndarray, info: list) -> Tuple[np.ndarray, np.ndarray]:
    """(n_mb, 16, 16) luma and (n_mb, 2, 8, 8) chroma residuals; a 16x16
    macroblock's luma DCs come from its Y2 block. Also whether each
    macroblock has a non-zero coefficient after the WHT (libwebp's test for
    filtering its inner edges)."""
    n = len(coef)
    y = coef[:, :256].reshape(n, 16, 16).copy()
    i16 = np.array([m[1] is None for m in info])
    if i16.any():
        y[i16, :, 0] = _wht(coef[i16, 384:400])
    nonzero = (y != 0).any((1, 2)) | (coef[:, 256:384] != 0).any(1)
    ry = idct(y.reshape(-1, 16)).reshape(n, 4, 4, 4, 4).transpose(0, 1, 3, 2, 4).reshape(n, 16, 16)
    ruv = idct(coef[:, 256:384].reshape(-1, 16)).reshape(n, 2, 2, 2, 4, 4)
    ruv = ruv.transpose(0, 1, 2, 4, 3, 5).reshape(n, 2, 8, 8)
    return ry, ruv, nonzero


def _avg3(a, b, c):
    return (a + 2 * b + c + 2) >> 2


def _avg2(a, b):
    return (a + b + 1) >> 1


def _predict4(mode: int, A: list, I: list, X: int) -> np.ndarray:
    """A 4x4 luma prediction (libwebp's ``VE4`` ... ``HU4``): ``A`` the 8
    pixels above (then above-right), ``I`` the 4 on the left, ``X`` the one
    above-left -> (4, 4)."""
    if mode == 0:  # DC
        return np.full((4, 4), (sum(A[:4]) + sum(I) + 4) >> 3)
    if mode == 1:  # TM
        return np.clip(np.array(I)[:, None] + np.array(A[:4])[None, :] - X, 0, 255)
    if mode == 2:  # VE
        t = [X] + A[:5]
        return np.tile([_avg3(t[k], t[k + 1], t[k + 2]) for k in range(4)], (4, 1))
    if mode == 3:  # HE
        col = [X] + I + [I[3]]
        return np.repeat([[_avg3(col[k], col[k + 1], col[k + 2])] for k in range(4)], 4, 1)
    d = np.empty((4, 4), np.int64)  # d[y, x]
    a, b, c, dd, e, f, g, hh = A
    i, j, k, l = I  # noqa: E741
    if mode == 4:  # RD
        e_ = [_avg3(j, k, l), _avg3(i, j, k), _avg3(X, i, j), _avg3(a, X, i), _avg3(b, a, X),
              _avg3(c, b, a), _avg3(dd, c, b)]
        for y in range(4):
            for x in range(4):
                d[y, x] = e_[3 - y + x]
    elif mode == 5:  # VR
        d[0] = [_avg2(X, a), _avg2(a, b), _avg2(b, c), _avg2(c, dd)]
        d[1] = [_avg3(i, X, a), _avg3(X, a, b), _avg3(a, b, c), _avg3(b, c, dd)]
        d[2] = [_avg3(j, i, X), d[0, 0], d[0, 1], d[0, 2]]
        d[3] = [_avg3(k, j, i), d[1, 0], d[1, 1], d[1, 2]]
    elif mode == 6:  # LD
        e_ = [_avg3(a, b, c), _avg3(b, c, dd), _avg3(c, dd, e), _avg3(dd, e, f),
              _avg3(e, f, g), _avg3(f, g, hh), _avg3(g, hh, hh)]
        for y in range(4):
            for x in range(4):
                d[y, x] = e_[x + y]
    elif mode == 7:  # VL
        d[0] = [_avg2(a, b), _avg2(b, c), _avg2(c, dd), _avg2(dd, e)]
        d[1] = [_avg3(a, b, c), _avg3(b, c, dd), _avg3(c, dd, e), _avg3(dd, e, f)]
        d[2] = [d[0, 1], d[0, 2], d[0, 3], _avg3(e, f, g)]
        d[3] = [d[1, 1], d[1, 2], d[1, 3], _avg3(f, g, hh)]
    elif mode == 8:  # HD
        d[0] = [_avg2(i, X), _avg3(i, X, a), _avg3(X, a, b), _avg3(a, b, c)]
        d[1] = [_avg2(j, i), _avg3(j, i, X), d[0, 0], d[0, 1]]
        d[2] = [_avg2(k, j), _avg3(k, j, i), d[1, 0], d[1, 1]]
        d[3] = [_avg2(l, k), _avg3(l, k, j), d[2, 0], d[2, 1]]
    else:  # HU
        d[0] = [_avg2(i, j), _avg3(i, j, k), _avg2(j, k), _avg3(j, k, l)]
        d[1] = [d[0, 2], d[0, 3], _avg2(k, l), _avg3(k, l, l)]
        d[2] = [d[1, 2], d[1, 3], l, l]
        d[3] = [l, l, l, l]
    return d


def _predict_block(plane: np.ndarray, y0: int, x0: int, n: int, mode: int, mbx: int,
                   mby: int) -> np.ndarray:
    """A 16x16 luma or 8x8 chroma prediction at padded position (y0, x0)
    (``plane`` has one border row above and one border column left)."""
    top = plane[y0 - 1, x0:x0 + n]
    left = plane[y0:y0 + n, x0 - 1]
    if mode == _DC:
        shift = 5 if n == 16 else 4
        if mbx and mby:
            v = (int(top.sum()) + int(left.sum()) + (1 << (shift - 1))) >> shift
        elif mbx:  # the first row: the left samples alone
            v = (int(left.sum()) + (1 << (shift - 2))) >> (shift - 1)
        elif mby:  # the first column: the top samples alone
            v = (int(top.sum()) + (1 << (shift - 2))) >> (shift - 1)
        else:
            v = 128
        return np.full((n, n), v, np.int64)
    if mode == _TM:
        return np.clip(left[:, None] + top[None, :] - plane[y0 - 1, x0 - 1], 0, 255)
    if mode == _V:
        return np.broadcast_to(top, (n, n))
    return np.broadcast_to(left[:, None], (n, n))


def _reconstruct(w, h, mbw, mbh, info, ry, ruv):
    """Unfiltered Y, U, V planes of the macroblock grid (each with its border
    row and column in front)."""
    Y = np.full((16 * mbh + 1, 16 * mbw + 5), 127, np.int64)
    Y[1:, 0] = 129
    UV = np.full((2, 8 * mbh + 1, 8 * mbw + 1), 127, np.int64)
    UV[:, 1:, 0] = 129
    k = 0
    for mby in range(mbh):
        y0 = 16 * mby + 1
        if mby:  # the rightmost macroblock's top-right pixels repeat the one above
            Y[y0 - 1, 16 * mbw + 1:] = Y[y0 - 1, 16 * mbw]
        for mbx in range(mbw):
            _, sub, ymode, uv, _ = info[k]
            x0 = 16 * mbx + 1
            if sub is None:
                pred = _predict_block(Y, y0, x0, 16, ymode, mbx, mby)
                Y[y0:y0 + 16, x0:x0 + 16] = np.clip(pred + ry[k], 0, 255)
            else:
                right = Y[y0 - 1, x0 + 16:x0 + 20].tolist()  # the macroblock's top-right
                r = ry[k]
                for n, mode in enumerate(sub):
                    by, bx = divmod(n, 4)
                    yy, xx = y0 + 4 * by, x0 + 4 * bx
                    above = Y[yy - 1, xx:xx + 8].tolist()
                    if bx == 3:
                        above[4:] = right
                    pred = _predict4(mode, above, Y[yy:yy + 4, xx - 1].tolist(),
                                     int(Y[yy - 1, xx - 1]))
                    Y[yy:yy + 4, xx:xx + 4] = np.clip(pred + r[4 * by:4 * by + 4,
                                                                4 * bx:4 * bx + 4], 0, 255)
            c0, cx = 8 * mby + 1, 8 * mbx + 1
            for p in range(2):
                pred = _predict_block(UV[p], c0, cx, 8, uv, mbx, mby)
                UV[p, c0:c0 + 8, cx:cx + 8] = np.clip(pred + ruv[k, p], 0, 255)
            k += 1
    return Y[1:, 1:16 * mbw + 1], UV[:, 1:, 1:]


# ------------------------------------------------------------- loop filter
def _strengths(hdr: dict):
    """libwebp's ``PrecomputeFilterStrengths`` -> [segment][is 4x4] =
    (limit, interior limit, hev threshold)."""
    out = []
    for s in range(4):
        base = hdr["level"]
        if hdr["use_segment"]:
            base = hdr["strength"][s] + (0 if hdr["absolute"] else hdr["level"])
        row = []
        for i4 in (0, 1):
            level = base
            if hdr["use_lf_delta"]:
                level += hdr["ref_delta"][0] + (hdr["mode_delta"][0] if i4 else 0)
            level = _clip(level, 63)
            if level <= 0:
                row.append((0, 0, 0))
                continue
            ilevel = level
            if hdr["sharpness"] > 0:
                ilevel >>= 2 if hdr["sharpness"] > 4 else 1
                ilevel = min(ilevel, 9 - hdr["sharpness"])
            ilevel = max(ilevel, 1)
            row.append((2 * level + ilevel, ilevel, 2 if level >= 40 else 1 if level >= 15 else 0))
        out.append(row)
    return out


def _filter_lines(seg: np.ndarray, thresh, ithresh, hev_t, kind: str) -> np.ndarray:
    """libwebp's edge filters on (k, lines, 8) pixels across an edge
    (p3 p2 p1 p0 | q0 q1 q2 q3), thresholds (k, 1): ``kind`` 'simple',
    'edge' (a macroblock edge, ``DoFilter6``) or 'inner' (``DoFilter4``)."""
    p3, p2, p1, p0, q0, q1, q2, q3 = (seg[..., i] for i in range(8))
    mask = 4 * np.abs(p0 - q0) + np.abs(p1 - q1) <= 2 * thresh + 1
    out = seg.copy()
    a = 3 * (q0 - p0) + np.clip(p1 - q1, -128, 127)
    f2_p0 = np.clip(p0 + np.clip((a + 3) >> 3, -16, 15), 0, 255)
    f2_q0 = np.clip(q0 - np.clip((a + 4) >> 3, -16, 15), 0, 255)
    if kind == "simple":
        out[..., 3] = np.where(mask, f2_p0, p0)
        out[..., 4] = np.where(mask, f2_q0, q0)
        return out
    for u, v in ((p3, p2), (p2, p1), (p1, p0), (q3, q2), (q2, q1), (q1, q0)):
        mask &= np.abs(u - v) <= ithresh
    hev = (np.abs(p1 - p0) > hev_t) | (np.abs(q1 - q0) > hev_t)
    two, rest = mask & hev, mask & ~hev
    if kind == "edge":
        a = np.clip(3 * (q0 - p0) + np.clip(p1 - q1, -128, 127), -128, 127)
        a1, a2, a3 = (27 * a + 63) >> 7, (18 * a + 63) >> 7, (9 * a + 63) >> 7
        new = {1: p2 + a3, 2: p1 + a2, 3: p0 + a1, 4: q0 - a1, 5: q1 - a2, 6: q2 - a3}
    else:
        a = 3 * (q0 - p0)
        a1, a2 = np.clip((a + 4) >> 3, -16, 15), np.clip((a + 3) >> 3, -16, 15)
        a3 = (a1 + 1) >> 1
        new = {2: p1 + a3, 3: p0 + a2, 4: q0 - a1, 5: q1 - a3}
    for i, v in new.items():
        out[..., i] = np.where(rest, np.clip(v, 0, 255), out[..., i])
    out[..., 3] = np.where(two, f2_p0, out[..., 3])
    out[..., 4] = np.where(two, f2_q0, out[..., 4])
    return out


def _loop_filter(Y: np.ndarray, UV: np.ndarray, mbw: int, mbh: int, info: list,
                 nonzero: np.ndarray, hdr: dict) -> None:
    """libwebp's ``DoFilter`` on every macroblock, in place: the left edge,
    the inner vertical edges, the top edge, the inner horizontal edges. The
    macroblocks on one line ``mbx + 2 mby`` touch disjoint pixels and depend
    only on earlier lines, so each line is filtered at once."""
    if hdr["level"] == 0:
        return
    simple = hdr["simple"]
    strength = _strengths(hdr)
    params = np.zeros((mbh * mbw, 4), np.int64)  # limit, ilevel, hev threshold, inner
    for k, (seg, sub, _, _, skip) in enumerate(info):
        limit, ilevel, hev = strength[seg][sub is not None]
        inner = sub is not None or not (skip or not nonzero[k])
        params[k] = (limit, ilevel, hev, inner)
    mby, mbx = np.divmod(np.arange(mbh * mbw), mbw)
    wave = mbx + 2 * mby
    planes = [(Y, 16)] + ([] if simple else [(UV[0], 8), (UV[1], 8)])
    for t in range(int(wave.max()) + 1):
        ks = np.flatnonzero((wave == t) & (params[:, 0] > 0))
        if not len(ks):
            continue
        for plane, n in planes:
            for vertical in (True, False):
                steps = [(0, True)] + [(o, False) for o in range(4, n, 4)]
                for offset, edge in steps:
                    if edge:
                        sel = ks[(mbx[ks] if vertical else mby[ks]) > 0]
                    else:
                        sel = ks[params[ks, 3] > 0]
                    if not len(sel):
                        continue
                    _filter_edge(plane, sel, mbx, mby, n, offset, vertical, edge, params,
                                 simple)


def _filter_edge(plane, sel, mbx, mby, n, offset, vertical, edge, params, simple) -> None:
    lines = np.arange(n)
    across = np.arange(-4, 4)
    if vertical:  # a vertical edge at column offset: lines are rows
        rows = (n * mby[sel])[:, None, None] + lines[None, :, None]
        cols = (n * mbx[sel] + offset)[:, None, None] + across[None, None, :]
    else:
        rows = (n * mby[sel] + offset)[:, None, None] + across[None, None, :]
        cols = (n * mbx[sel])[:, None, None] + lines[None, :, None]
    seg = plane[rows, cols]
    p = params[sel]
    limit = p[:, 0:1] + (4 if edge else 0)
    kind = "simple" if simple else "edge" if edge else "inner"
    plane[rows, cols] = _filter_lines(seg, limit, p[:, 1:2], p[:, 2:3], kind)


# ------------------------------------------------------------------ output
def _upsample(c: np.ndarray, h: int, w: int) -> np.ndarray:
    """libwebp's fancy upsampler of one (ceil(h/2), ceil(w/2)) chroma plane ->
    (h, w): each sample from its nearest chroma sample N, the next one across
    H, the next one down V and the diagonal F, ``(((N + 3H + 3V + F + 8) >> 3)
    + N) >> 1``, with the plane's edges repeated."""
    ch, cw = c.shape
    r = np.arange(h)
    near_r = r // 2
    far_r = np.clip(near_r + np.where(r % 2, 1, -1), 0, ch - 1)
    x = np.arange(w)
    near_c = x // 2
    far_c = np.clip(near_c + np.where(x % 2, 1, -1), 0, cw - 1)
    N = c[near_r[:, None], near_c[None, :]]
    H = c[near_r[:, None], far_c[None, :]]
    V = c[far_r[:, None], near_c[None, :]]
    F = c[far_r[:, None], far_c[None, :]]
    return (((N + 3 * (H + V) + F + 8) >> 3) + N) >> 1


def yuv_to_rgb(y: np.ndarray, u: np.ndarray, v: np.ndarray) -> np.ndarray:
    """libwebp's ``VP8YUVToR/G/B`` -> (..., 3) uint8."""
    def mult(a, c):
        return (a * c) >> 8

    yy = mult(y, 19077)
    rgb = [yy + mult(v, 26149) - 14234, yy - mult(u, 6419) - mult(v, 13320) + 8708,
           yy + mult(u, 33050) - 17685]
    return np.stack([np.clip(c >> 6, 0, 255) for c in rgb], -1).astype(np.uint8)


def decode_vp8(data: bytes, name: str = "<bytes>") -> np.ndarray:
    """A ``VP8 `` chunk's payload (and whatever follows it, as libwebp reads
    the last partition to the end of its buffer) -> (H, W, 3) uint8 RGB."""
    w, h, mbw, mbh, coef, info, hdr = _parse(data, name)
    ry, ruv, nonzero = _residuals(coef, info)
    Y, UV = _reconstruct(w, h, mbw, mbh, info, ry, ruv)
    _loop_filter(Y, UV, mbw, mbh, info, nonzero, hdr)
    ch, cw = (h + 1) // 2, (w + 1) // 2
    u = _upsample(UV[0, :ch, :cw], h, w)
    v = _upsample(UV[1, :ch, :cw], h, w)
    return yuv_to_rgb(Y[:h, :w], u, v)


def frame_size(data: bytes, chunk_size: int, name: str = "<bytes>") -> Tuple[int, int]:
    """libwebp's ``VP8GetInfo``: the size of a key frame, refusing what it
    refuses (a first partition as long as the chunk or longer)."""
    if len(data) < 10 or data[3:6] != b"\x9d\x01\x2a":
        raise ValueError(f"{name}: not a WebP lossy bitstream")
    bits = data[0] | (data[1] << 8) | (data[2] << 16)
    w = (data[6] | (data[7] << 8)) & 0x3FFF
    h = (data[8] | (data[9] << 8)) & 0x3FFF
    if bits & 1 or (bits >> 1) & 7 > 3 or not (bits >> 4) & 1 or bits >> 5 >= chunk_size \
            or not w or not h:
        raise ValueError(f"{name}: WebP lossy frame header refused")
    return w, h


__all__ = ["decode_vp8", "frame_size", "idct", "yuv_to_rgb", "ZIGZAG", "BANDS"]
