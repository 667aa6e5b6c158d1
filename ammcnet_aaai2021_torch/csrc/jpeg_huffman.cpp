// The entropy decode of JPEG frames, without libjpeg: markers, Huffman-
// or arithmetic-coded sequential and progressive scans, quantized DCT
// coefficients out.
//
// The GPU route of the port's loader (jpeg_decode.cu, which includes this
// file) runs libjpeg's accurate integer IDCT on the card, so the card's
// frames are bitwise what libjpeg gives on the host (ammc_loader.cpp).  The
// card needs the coefficients for that, and the only JPEG library on its
// machine (nvJPEG) hands out pixels, not coefficients: this file is the
// decode up to the coefficients, in the order libjpeg-turbo 2.1.5's
// jdmarker.c, jdhuff.c, jdphuff.c, jdarith.c and jdcoefct.c do it.
//
// It takes what that libjpeg's 8-bit decoder takes: SOI; DQT (8- and 16-bit
// tables); SOF0, SOF1 (sequential Huffman), SOF2 (progressive Huffman),
// SOF9 (sequential arithmetic) and SOF10 (progressive arithmetic) with
// 8-bit samples and 1 or 3 components; DHT; DAC (arithmetic conditioning,
// libjpeg's defaults L = 0, U = 1, K = 5 without one); DRI and RSTn; SOS,
// interleaved and non-interleaved (a component's scan then covers its own
// blocks, not the MCU grid); APPn and COM, skipped (APP0 JFIF and APP14
// Adobe read for the colour space, as jdapimin.c guesses it); EOI.
// Progressive scans (DC first and refine, interleaved or not; AC first
// with spectral selection and EOB runs; AC refine, which corrects the
// coefficients earlier scans decoded and keeps their sign; successive
// approximation) add into the component's whole-image blocks, which start
// at zero, as jdcoefct.c's virtual arrays do.  A progressive frame whose
// scans leave one of the first ten coefficients unrefined is block-smoothed
// as libjpeg smooths it at output (jdcoefct.c decompress_smooth_data,
// below: `smooth_component`).  It refuses, each with its own code: lossless
// and hierarchical frames (libjpeg refuses them too), sample precision
// other than 8 bits (libjpeg's 8-bit decoder refuses them), other than 1
// or 3 components, a 3-component frame that is not YCbCr, a progressive
// scan whose parameters libjpeg rejects, and a malformed DAC.  There is no
// fallback: the caller raises on the code.
//
// Where libjpeg only warns, the port goes on as libjpeg does: a
// progressive scan out of order (an AC scan before its DC scan, a refine
// scan without its first scan, JWRN_BOGUS_PROGRESSION) adds into what the
// blocks hold; a sequential scan whose Ss, Se, Ah, Al are not 0, 63, 0, 0
// (JWRN_NOT_SEQUENTIAL) is decoded as a sequential scan; an arithmetic
// code that overflows (JWRN_ARITH_BAD_CODE) leaves the rest of its
// restart interval at what the blocks hold.  A truncated or cut-short
// stream decodes as libjpeg-turbo decodes it: past the end of the file
// the bytes read as its source manager's fake EOI (0xFF 0xD9 repeated);
// a Huffman MCU that needs bits past a premature marker or that end gets
// zero bits (JWRN_HIT_MARKER) and every later MCU of the scan is skipped
// (jdhuff.c, jdphuff.c insufficient_data), its blocks left as they are:
// zero in a sequential frame (the blocks are zeroed at the SOF, as
// libjpeg zeroes its MCU buffer and pre-zeroes its arrays), what earlier
// scans left in a progressive one; an arithmetic scan goes on with zero
// bytes, where that is legal.  At a restart boundary the next marker is
// taken as jdmarker.c read_restart_marker and jpeg_resync_to_restart take
// it: the RSTn expected (or one too far off) is swallowed and the decode
// resumes after it (a Huffman scan's skipping ends there), a prior RSTn
// or an invalid marker is scanned past, and the next two RSTn or any
// other marker (an EOI: the real one or the fake one) is left unread, so
// the rest of the scan reads zeros.  A component that no scan coded
// before the EOI is a flat 128 plane (zero coefficients and table), as
// libjpeg outputs it.
//
// Per component the decode yields its sampling factors, its downsampled
// size (libjpeg's: ceil(image_w * h_samp / max_h_samp), likewise the
// height), its quantization table in natural order (latched at the
// component's first scan, as jdinput.c latches it) and its blocks,
// (blocks_h, blocks_w, 64) int16 in natural order, blocks_w =
// ceil(width / 8): the blocks libjpeg keeps, as jpeg_read_coefficients
// gives them (unsmoothed).  An interleaved scan's dummy blocks past the
// right or bottom edge are decoded and dropped.  With them comes the
// frame's smoothing latch (`Smoothing`): whether libjpeg smooths the frame
// at output, each component's coef_bits[0..9] and their second row, and
// the last good iMCU row.
//
// C ABI, built alone with g++ into the "coef" form of the host library
// (ammcnet_aaai2021_torch/data/native.py), no libjpeg:
//   ammc_jpeg_info(path, info[kInfoInts])                  -> 0 | errcode
//   ammc_jpeg_coefs_video(paths, n, threads, coefs, qtables, latch)
//                                                          -> 0 | errcode
//   ammc_jpeg_smooth(in, out, blocks_h, blocks_w, v_samp, imcu_rows,
//                    qtable, coef_bits, prev_bits, last_good) -> 0
// Error codes (data/native.py:ERRORS): 2 a file that does not open, 3
// corrupt data, 8 components other than 1 or 3, 10 a progressive scan
// whose parameters libjpeg rejects, 11 lossless or hierarchical, 12 a
// malformed DAC segment, 13 sample precision other than 8 bits, 14 a
// 3-component frame coded other than as YCbCr.

#include <algorithm>
#include <atomic>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <thread>
#include <vector>

namespace ammc_jpeg {

enum : int {
  kOk = 0,
  kNoFile = 2,
  kCorrupt = 3,
  kComponents = 8,
  kProgressive = 10,  // a progressive scan whose parameters libjpeg rejects
  kLossless = 11,
  kArithmetic = 12,  // a malformed DAC segment
  kPrecision = 13,
  kColorSpace = 14,
};

constexpr int kMaxComps = 3;

// zigzag position -> natural (row-major) position (jutils.c
// jpeg_natural_order, with its 16 extra entries: a corrupt run past the
// band's end lands on coefficient 63, as in libjpeg)
constexpr int kNaturalOrder[80] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
    63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

constexpr int kArithTables = 16;  // NUM_ARITH_TBLS
constexpr int kSavedCoefs = 10;   // jdcoefct.c SAVED_COEFS (block smoothing)

struct Component {
  int id = 0, h_samp = 1, v_samp = 1, tq = 0;
  int width = 0, height = 0;      // downsampled size
  int blocks_w = 0, blocks_h = 0;  // ceil(size / 8)
};

struct Info {
  int width = 0, height = 0, ncomp = 0, max_h = 1, max_v = 1;
  Component comp[kMaxComps];
  // jdinput.c total_iMCU_rows: rows of max_v * 8 pixels
  int imcu_rows() const { return (height + 8 * max_v - 1) / (8 * max_v); }
};

// jdcoefct.c smoothing_ok's latch at the output pass (libjpeg-turbo
// 2.1.5): whether libjpeg block-smooths the frame; per component
// coef_bits[0..9] as the last scan left them (coef_bits_latch) and the
// second row, coef_bits[1..9] before the component's last scan (0 if that
// was the frame's first scan; -1 throughout if the frame has one scan);
// and the frame's last good iMCU row (cinfo->master->last_good_iMCU_row:
// the row of the last MCU that began with sufficient data).
// decompress_smooth_data reads the second row for the iMCU rows past the
// last good one, which a frame whose scans run to their end does not have.
struct Smoothing {
  bool apply = false;
  int last_good = 0;
  int bits[kMaxComps][kSavedCoefs];
  int prev[kMaxComps][kSavedCoefs];
};

// A Huffman table as jdhuff.c's derived table: per code length, the
// largest code and the offset of its first value, plus an 8-bit lookahead.
struct Huffman {
  bool defined = false;
  int32_t maxcode[17];  // maxcode[l]: largest code of length l, -1 if none
  int32_t valoffset[17];
  uint8_t huffval[256];
  uint16_t look[256];  // (length << 8) | value for codes of <= 8 bits, 0 else
};

int build_huffman(const uint8_t bits[17], const uint8_t* vals, int nvals,
                  Huffman* t) {
  std::memcpy(t->huffval, vals, nvals);
  uint16_t code = 0;
  int p = 0;
  std::memset(t->look, 0, sizeof(t->look));
  for (int l = 1; l <= 16; ++l) {
    if (bits[l]) {
      t->valoffset[l] = p - code;
      for (int i = 0; i < bits[l]; ++i, ++p, ++code) {
        if (l <= 8) {
          const int shift = 8 - l;
          for (int j = 0; j < (1 << shift); ++j) {
            t->look[(code << shift) | j] =
                static_cast<uint16_t>((l << 8) | vals[p]);
          }
        }
      }
      t->maxcode[l] = code - 1;
      // a code that overflows its length is corrupt (jdhuff.c checks it)
      if (code > (1u << l)) return kCorrupt;
    } else {
      t->maxcode[l] = -1;
    }
    code <<= 1;
  }
  t->defined = true;
  return kOk;
}

// Entropy-coded data: a 64-bit bit buffer filled a byte at a time, 0xFF00
// unstuffed; at a marker (or the end) it feeds zeros.  `real` counts the
// buffered bits that came from the data; `hit` is set when a read takes
// more than those (jdhuff.c jpeg_fill_bit_buffer's insufficient data).
struct BitReader {
  const uint8_t* p;
  const uint8_t* end;
  uint64_t buf = 0;
  int bits = 0;
  int real = 0;
  bool at_marker = false;
  bool hit = false;

  void fill() {
    while (bits <= 56) {
      uint8_t b = 0;
      if (!at_marker && p < end) {
        b = *p;
        if (b == 0xFF) {
          const uint8_t* q = p + 1;
          while (q < end && *q == 0xFF) ++q;  // fill bytes
          if (q < end && *q == 0x00) {
            p = q + 1;
            real += 8;
          } else {
            at_marker = true;  // p stays on the marker's 0xFF
            p = q - 1;
            b = 0;
          }
        } else {
          ++p;
          real += 8;
        }
      }
      buf |= static_cast<uint64_t>(b) << (56 - bits);
      bits += 8;
    }
  }
  void take(int n) {
    if (n > real) {
      hit = true;
      real = 0;
    } else {
      real -= n;
    }
  }
  int get(int n) {  // n <= 16
    if (n == 0) return 0;
    if (bits < n) fill();
    const int v = static_cast<int>(buf >> (64 - n));
    buf <<= n;
    bits -= n;
    take(n);
    return v;
  }
  int peek8() {
    if (bits < 8) fill();
    return static_cast<int>(buf >> 56);
  }
  void skip(int n) {
    buf <<= n;
    bits -= n;
    take(n);
  }
  // Drop the buffered bits and stand on the next marker (or the end).
  void to_marker() {
    buf = 0;
    bits = real = 0;
    if (at_marker) return;
    while (p + 1 < end && !(p[0] == 0xFF && p[1] != 0x00 && p[1] != 0xFF)) {
      ++p;
    }
    if (p + 1 >= end) p = end;  // no marker: the fake EOI past the data
    at_marker = true;
  }
};

// The rest of a code longer than 8 bits (jdhuff.c jpeg_huff_decode), or
// -1 on a bad code.
inline int decode_slow(BitReader* br, const Huffman& t, int first8) {
  int32_t code = first8;
  int l = 8;
  while (code > t.maxcode[l]) {
    code = (code << 1) | br->get(1);
    if (++l > 16) return -1;
  }
  return t.huffval[(t.valoffset[l] + code) & 0xFF];
}

// One Huffman symbol (jdhuff.c HUFF_DECODE), or -1 on a bad code.
inline int huff_decode(BitReader* br, const Huffman& t) {
  const int first8 = br->peek8();
  const int look = t.look[first8];
  if (look) {
    br->skip(look >> 8);
    return look & 0xFF;
  }
  br->skip(8);
  return decode_slow(br, t, first8);
}

// jdhuff.c HUFF_EXTEND: s bits of magnitude -> a signed value.
inline int extend(int v, int s) {
  return v < (1 << (s - 1)) ? v - (1 << s) + 1 : v;
}

// The start of the next marker at or after p (its first 0xFF), skipping
// data bytes and stuffed 0xFF00 pairs as jdmarker.c next_marker does; end
// if there is none.
inline const uint8_t* find_marker(const uint8_t* p, const uint8_t* end) {
  while (p + 1 < end) {
    if (p[0] != 0xFF) {
      ++p;
      continue;
    }
    const uint8_t* q = p + 1;
    while (q < end && *q == 0xFF) ++q;
    if (q < end && *q != 0x00) return p;
    p = q;  // FF00 (or the end): not a marker
  }
  return end;
}

// The code of the marker whose first 0xFF is at `at`; past the data it is
// the EOI that libjpeg's source manager inserts.
inline int marker_code(const uint8_t* at, const uint8_t* end) {
  while (at < end && *at == 0xFF) ++at;
  return at < end ? *at : 0xD9;
}

// The first byte after the marker at `at`.
inline const uint8_t* past_marker(const uint8_t* at, const uint8_t* end) {
  while (at < end && *at == 0xFF) ++at;
  return at < end ? at + 1 : end;
}

// jdmarker.c read_restart_marker with jpeg_resync_to_restart, from the
// marker at *at with RSTn `rst` expected: the expected marker, or an RSTn
// too far off, is swallowed and the data resumes past it (returned); a
// prior RSTn or an invalid code (below SOF0) is scanned past to the next
// marker; the next two RSTn or any other marker (an EOI) is left unread:
// nullptr, *at on it.
inline const uint8_t* resync_to_restart(const uint8_t** at,
                                        const uint8_t* end, int rst) {
  for (;;) {
    const int code = marker_code(*at, end);
    const int ahead = (code - 0xD0 - rst) & 7;
    if (code < 0xC0 || (code >= 0xD0 && code <= 0xD7 && ahead >= 6)) {
      *at = find_marker(past_marker(*at, end), end);  // scan on
    } else if (code < 0xD0 || code > 0xD7 || ahead == 1 || ahead == 2) {
      return nullptr;  // left unread
    } else {
      return past_marker(*at, end);
    }
  }
}

// jaricom.c jpeg_aritab: Table D.2 of ITU-T T.81 (Qe, then the next state
// after an LPS and after an MPS, and whether an LPS switches the MPS),
// packed as libjpeg packs it: Qe << 16 | NMPS << 8 | SWITCH << 7 | NLPS.
// Entry 113 is the fixed probability 0.5 (ITU-T T.851).
#define AMMC_ARI(qe, nlps, nmps, sw) \
  ((static_cast<int32_t>(qe) << 16) | ((nmps) << 8) | ((sw) << 7) | (nlps))
constexpr int32_t kAriTab[114] = {
    AMMC_ARI(0x5a1d, 1, 1, 1),     AMMC_ARI(0x2586, 14, 2, 0),
    AMMC_ARI(0x1114, 16, 3, 0),    AMMC_ARI(0x080b, 18, 4, 0),
    AMMC_ARI(0x03d8, 20, 5, 0),    AMMC_ARI(0x01da, 23, 6, 0),
    AMMC_ARI(0x00e5, 25, 7, 0),    AMMC_ARI(0x006f, 28, 8, 0),
    AMMC_ARI(0x0036, 30, 9, 0),    AMMC_ARI(0x001a, 33, 10, 0),
    AMMC_ARI(0x000d, 35, 11, 0),   AMMC_ARI(0x0006, 9, 12, 0),
    AMMC_ARI(0x0003, 10, 13, 0),   AMMC_ARI(0x0001, 12, 13, 0),
    AMMC_ARI(0x5a7f, 15, 15, 1),   AMMC_ARI(0x3f25, 36, 16, 0),
    AMMC_ARI(0x2cf2, 38, 17, 0),   AMMC_ARI(0x207c, 39, 18, 0),
    AMMC_ARI(0x17b9, 40, 19, 0),   AMMC_ARI(0x1182, 42, 20, 0),
    AMMC_ARI(0x0cef, 43, 21, 0),   AMMC_ARI(0x09a1, 45, 22, 0),
    AMMC_ARI(0x072f, 46, 23, 0),   AMMC_ARI(0x055c, 48, 24, 0),
    AMMC_ARI(0x0406, 49, 25, 0),   AMMC_ARI(0x0303, 51, 26, 0),
    AMMC_ARI(0x0240, 52, 27, 0),   AMMC_ARI(0x01b1, 54, 28, 0),
    AMMC_ARI(0x0144, 56, 29, 0),   AMMC_ARI(0x00f5, 57, 30, 0),
    AMMC_ARI(0x00b7, 59, 31, 0),   AMMC_ARI(0x008a, 60, 32, 0),
    AMMC_ARI(0x0068, 62, 33, 0),   AMMC_ARI(0x004e, 63, 34, 0),
    AMMC_ARI(0x003b, 32, 35, 0),   AMMC_ARI(0x002c, 33, 9, 0),
    AMMC_ARI(0x5ae1, 37, 37, 1),   AMMC_ARI(0x484c, 64, 38, 0),
    AMMC_ARI(0x3a0d, 65, 39, 0),   AMMC_ARI(0x2ef1, 67, 40, 0),
    AMMC_ARI(0x261f, 68, 41, 0),   AMMC_ARI(0x1f33, 69, 42, 0),
    AMMC_ARI(0x19a8, 70, 43, 0),   AMMC_ARI(0x1518, 72, 44, 0),
    AMMC_ARI(0x1177, 73, 45, 0),   AMMC_ARI(0x0e74, 74, 46, 0),
    AMMC_ARI(0x0bfb, 75, 47, 0),   AMMC_ARI(0x09f8, 77, 48, 0),
    AMMC_ARI(0x0861, 78, 49, 0),   AMMC_ARI(0x0706, 79, 50, 0),
    AMMC_ARI(0x05cd, 48, 51, 0),   AMMC_ARI(0x04de, 50, 52, 0),
    AMMC_ARI(0x040f, 50, 53, 0),   AMMC_ARI(0x0363, 51, 54, 0),
    AMMC_ARI(0x02d4, 52, 55, 0),   AMMC_ARI(0x025c, 53, 56, 0),
    AMMC_ARI(0x01f8, 54, 57, 0),   AMMC_ARI(0x01a4, 55, 58, 0),
    AMMC_ARI(0x0160, 56, 59, 0),   AMMC_ARI(0x0125, 57, 60, 0),
    AMMC_ARI(0x00f6, 58, 61, 0),   AMMC_ARI(0x00cb, 59, 62, 0),
    AMMC_ARI(0x00ab, 61, 63, 0),   AMMC_ARI(0x008f, 61, 32, 0),
    AMMC_ARI(0x5b12, 65, 65, 1),   AMMC_ARI(0x4d04, 80, 66, 0),
    AMMC_ARI(0x412c, 81, 67, 0),   AMMC_ARI(0x37d8, 82, 68, 0),
    AMMC_ARI(0x2fe8, 83, 69, 0),   AMMC_ARI(0x293c, 84, 70, 0),
    AMMC_ARI(0x2379, 86, 71, 0),   AMMC_ARI(0x1edf, 87, 72, 0),
    AMMC_ARI(0x1aa9, 87, 73, 0),   AMMC_ARI(0x174e, 72, 74, 0),
    AMMC_ARI(0x1424, 72, 75, 0),   AMMC_ARI(0x119c, 74, 76, 0),
    AMMC_ARI(0x0f6b, 74, 77, 0),   AMMC_ARI(0x0d51, 75, 78, 0),
    AMMC_ARI(0x0bb6, 77, 79, 0),   AMMC_ARI(0x0a40, 77, 48, 0),
    AMMC_ARI(0x5832, 80, 81, 1),   AMMC_ARI(0x4d1c, 88, 82, 0),
    AMMC_ARI(0x438e, 89, 83, 0),   AMMC_ARI(0x3bdd, 90, 84, 0),
    AMMC_ARI(0x34ee, 91, 85, 0),   AMMC_ARI(0x2eae, 92, 86, 0),
    AMMC_ARI(0x299a, 93, 87, 0),   AMMC_ARI(0x2516, 86, 71, 0),
    AMMC_ARI(0x5570, 88, 89, 1),   AMMC_ARI(0x4ca9, 95, 90, 0),
    AMMC_ARI(0x44d9, 96, 91, 0),   AMMC_ARI(0x3e22, 97, 92, 0),
    AMMC_ARI(0x3824, 99, 93, 0),   AMMC_ARI(0x32b4, 99, 94, 0),
    AMMC_ARI(0x2e17, 93, 86, 0),   AMMC_ARI(0x56a8, 95, 96, 1),
    AMMC_ARI(0x4f46, 101, 97, 0),  AMMC_ARI(0x47e5, 102, 98, 0),
    AMMC_ARI(0x41cf, 103, 99, 0),  AMMC_ARI(0x3c3d, 104, 100, 0),
    AMMC_ARI(0x375e, 99, 93, 0),   AMMC_ARI(0x5231, 105, 102, 0),
    AMMC_ARI(0x4c0f, 106, 103, 0), AMMC_ARI(0x4639, 107, 104, 0),
    AMMC_ARI(0x415e, 103, 99, 0),  AMMC_ARI(0x5627, 105, 106, 1),
    AMMC_ARI(0x50e7, 108, 107, 0), AMMC_ARI(0x4b85, 109, 103, 0),
    AMMC_ARI(0x5597, 110, 109, 0), AMMC_ARI(0x504f, 111, 107, 0),
    AMMC_ARI(0x5a10, 110, 111, 1), AMMC_ARI(0x5522, 112, 109, 0),
    AMMC_ARI(0x59eb, 112, 111, 1), AMMC_ARI(0x5a1d, 113, 113, 0)};
#undef AMMC_ARI

// The QM decoder of jdarith.c: the C and A registers, the bit counter
// (-16 before the two initial bytes, -1 after an overflowing code), and
// the input, which at a marker (or the end of the file: libjpeg's source
// inserts an EOI) feeds zero bytes and remembers where the marker stands.
struct ArithReader {
  const uint8_t* p;
  const uint8_t* end;
  int64_t c = 0, a = 0;
  int ct = -16;
  int unread_marker = 0;
  const uint8_t* marker_at = nullptr;  // the marker's first 0xFF
  int fake = 0;

  int get_byte() {
    if (p < end) return *p++;
    return (fake++ & 1) ? 0xD9 : 0xFF;  // jdatasrc.c: a fake EOI
  }
  void reset() {
    c = a = 0;
    ct = -16;
  }
  // One binary decision in statistics bin *st (jdarith.c arith_decode).
  int decode(uint8_t* st) {
    while (a < 0x8000) {
      if (--ct < 0) {
        int data = 0;
        if (!unread_marker) {
          const uint8_t* at = p;
          data = get_byte();
          if (data == 0xFF) {
            do data = get_byte();
            while (data == 0xFF);
            if (data == 0) {
              data = 0xFF;  // a stuffed zero byte
            } else {
              unread_marker = data;
              marker_at = at < end ? at : end;
              data = 0;
            }
          }
        }
        c = (c << 8) | data;
        if ((ct += 8) < 0) {
          if (++ct == 0) a = 0x8000;  // got the 2 initial bytes
        }
      }
      a <<= 1;
    }
    int sv = *st;
    int64_t qe = kAriTab[sv & 0x7F];
    const int nl = static_cast<int>(qe & 0xFF);
    qe >>= 8;
    const int nm = static_cast<int>(qe & 0xFF);
    qe >>= 8;
    int64_t temp = a - qe;
    a = temp;
    temp <<= ct;
    if (c >= temp) {
      c -= temp;
      if (a < qe) {  // conditional LPS exchange
        a = qe;
        *st = static_cast<uint8_t>((sv & 0x80) ^ nm);
      } else {
        a = qe;
        *st = static_cast<uint8_t>((sv & 0x80) ^ nl);
        sv ^= 0x80;
      }
    } else if (a < 0x8000) {  // conditional MPS exchange
      if (a < qe) {
        *st = static_cast<uint8_t>((sv & 0x80) ^ nl);
        sv ^= 0x80;
      } else {
        *st = static_cast<uint8_t>((sv & 0x80) ^ nm);
      }
    }
    return sv >> 7;
  }
};

// The arithmetic decoder's per-scan statistics (jdarith.c): 64 DC bins
// and 256 AC bins a table, the DAC conditioning, and the fixed 0.5 bin.
struct ArithStats {
  uint8_t dc[kArithTables][64];
  uint8_t ac[kArithTables][256];
  uint8_t fixed_bin = 113;
};

// Figures F.21-F.24 after the sign: a magnitude category from bins st
// (X1 at `x1`; `category` the power of two it gives, which conditions the
// next DC), then its bit pattern; v = +-(pattern + 1), or false on an
// overflowing category (JWRN_ARITH_BAD_CODE).
inline bool arith_magnitude(ArithReader* ar, uint8_t* st, uint8_t* x1,
                            bool ac, int sign, int* v, int* category) {
  int m = ar->decode(st);
  if (m != 0) {
    bool more = true;
    if (ac) {
      more = ar->decode(st) != 0;
      if (more) m <<= 1;
    }
    if (more) {
      st = x1;
      while (ar->decode(st)) {
        if ((m <<= 1) == 0x8000) return false;
        st += 1;
      }
    }
  }
  *category = m;
  int val = m;
  st += 14;
  while (m >>= 1) {
    if (ar->decode(st)) val |= m;
  }
  val += 1;
  *v = sign ? -val : val;
  return true;
}

struct Decoder {
  Decoder(const uint8_t* d, size_t n) : data(d), size(n) {
    std::memset(dc_l, 0, sizeof(dc_l));
    std::memset(dc_u, 1, sizeof(dc_u));
    std::memset(ac_k, 5, sizeof(ac_k));
    for (auto& bits : coef_bits) {
      for (int& b : bits) b = -1;
    }
    std::memset(prev_bits, 0, sizeof(prev_bits));
  }
  const uint8_t* data;
  size_t size;
  size_t pos = 0;
  Info info;
  bool have_sof = false, jfif = false, adobe = false;
  int adobe_transform = -1;
  uint16_t qt[4][64];  // natural order
  bool qt_defined[4] = {false, false, false, false};
  Huffman dc[4], ac[4];
  int restart_interval = 0;
  bool progressive = false, arithmetic = false;
  // DAC conditioning (jdmarker.c get_soi's defaults)
  uint8_t dc_l[kArithTables], dc_u[kArithTables], ac_k[kArithTables];
  // jdinput.c coef_bits: per component and coefficient the Al of the last
  // progressive scan that coded it, -1 before any; prev_bits its second
  // row (jdphuff.c and jdarith.c start_pass: coef_bits[1..9] before the
  // component's latest scan, 0 at the frame's first scan)
  int coef_bits[kMaxComps][64];
  int prev_bits[kMaxComps][64];
  int scans = 0;  // SOS markers read (cinfo->input_scan_number)
  int last_good = 0;  // cinfo->master->last_good_iMCU_row
  // output: per component, its latched table and its blocks
  bool latched[kMaxComps] = {false, false, false};
  uint16_t* qt_out[kMaxComps] = {nullptr, nullptr, nullptr};
  int16_t* coefs[kMaxComps] = {nullptr, nullptr, nullptr};

  // Byte i of the stream; past the data, the fake EOI (0xFF 0xD9,
  // repeated) that libjpeg's source manager inserts there.
  uint8_t byte_at(size_t i) const {
    return i < size ? data[i] : ((i - size) & 1) ? 0xD9 : 0xFF;
  }
  int u8(uint8_t* v) {
    *v = byte_at(pos++);
    return kOk;
  }
  int u16(int* v) {
    *v = (byte_at(pos) << 8) | byte_at(pos + 1);
    pos += 2;
    return kOk;
  }
  // The next marker code, skipping any bytes before it (jdmarker.c
  // next_marker tolerates them, and stuffed 0xFF00 pairs).
  int next_marker(int* marker) {
    const uint8_t* at = find_marker(data + pos, data + size);
    if (at >= data + size) return kCorrupt;
    pos = static_cast<size_t>(at - data);
    while (data[pos] == 0xFF) ++pos;
    *marker = data[pos++];
    return kOk;
  }
  int segment(size_t* seg_end) {
    int len;
    if (u16(&len) != kOk || len < 2) return kCorrupt;
    *seg_end = pos + len - 2;
    return kOk;
  }

  int read_sof(int marker) {
    // SOF0 baseline, SOF1 extended sequential, SOF2 progressive (Huffman),
    // SOF9 sequential and SOF10 progressive (arithmetic); jdmarker.c
    // refuses the lossless (SOF3, SOF11) and hierarchical (SOF5-7,
    // SOF13-15) ones, and JPG (0xC8)
    if (marker == 0xC8) return kCorrupt;
    if (marker == 0xC3 || marker == 0xC5 || marker == 0xC6 ||
        marker == 0xC7 || marker >= 0xCB) {
      return kLossless;
    }
    progressive = marker == 0xC2 || marker == 0xCA;
    arithmetic = marker >= 0xC9;
    if (have_sof) return kCorrupt;
    size_t seg_end;
    if (segment(&seg_end) != kOk) return kCorrupt;
    uint8_t precision, nc;
    int h, w;
    if (u8(&precision) || u16(&h) || u16(&w) || u8(&nc)) return kCorrupt;
    if (precision != 8) return kPrecision;
    if (nc != 1 && nc != 3) return kComponents;
    if (h <= 0 || w <= 0) return kCorrupt;  // DNL heights are not taken
    info.width = w;
    info.height = h;
    info.ncomp = nc;
    info.max_h = info.max_v = 1;
    for (int c = 0; c < nc; ++c) {
      uint8_t id, hv, tq;
      if (u8(&id) || u8(&hv) || u8(&tq)) return kCorrupt;
      Component& cp = info.comp[c];
      cp.id = id;
      cp.h_samp = hv >> 4;
      cp.v_samp = hv & 15;
      cp.tq = tq;
      if (cp.h_samp < 1 || cp.h_samp > 4 || cp.v_samp < 1 || cp.v_samp > 4 ||
          tq > 3) {
        return kCorrupt;
      }
      info.max_h = cp.h_samp > info.max_h ? cp.h_samp : info.max_h;
      info.max_v = cp.v_samp > info.max_v ? cp.v_samp : info.max_v;
    }
    for (int c = 0; c < nc; ++c) {
      Component& cp = info.comp[c];
      // jdinput.c initial_setup: jdiv_round_up(image * samp, max_samp)
      cp.width = (w * cp.h_samp + info.max_h - 1) / info.max_h;
      cp.height = (h * cp.v_samp + info.max_v - 1) / info.max_v;
      cp.blocks_w = (cp.width + 7) / 8;
      cp.blocks_h = (cp.height + 7) / 8;
    }
    pos = seg_end;
    have_sof = true;
    // progressive scans add into the blocks: they start at zero, as
    // jdcoefct.c's pre-zeroed virtual arrays do
    for (int c = 0; c < nc; ++c) {
      if (coefs[c] != nullptr) {
        std::memset(coefs[c], 0,
                    sizeof(int16_t) * 64 * info.comp[c].blocks_w *
                        info.comp[c].blocks_h);
      }
    }
    return kOk;
  }

  // jdmarker.c get_dac: arithmetic conditioning values
  int read_dac() {
    size_t seg_end;
    if (segment(&seg_end) != kOk) return kCorrupt;
    if ((seg_end - pos) % 2) return kArithmetic;
    while (pos < seg_end) {
      const int index = byte_at(pos), val = byte_at(pos + 1);
      pos += 2;
      if (index >= 2 * kArithTables) return kArithmetic;
      if (index >= kArithTables) {
        ac_k[index - kArithTables] = static_cast<uint8_t>(val);
      } else {
        dc_l[index] = static_cast<uint8_t>(val & 15);
        dc_u[index] = static_cast<uint8_t>(val >> 4);
        if (dc_l[index] > dc_u[index]) return kArithmetic;
      }
    }
    return kOk;
  }

  int read_dqt() {
    size_t seg_end;
    if (segment(&seg_end) != kOk) return kCorrupt;
    while (pos < seg_end) {
      uint8_t pq_tq;
      if (u8(&pq_tq)) return kCorrupt;
      const int pq = pq_tq >> 4, tq = pq_tq & 15;
      if (tq > 3 || pq > 1) return kCorrupt;
      for (int i = 0; i < 64; ++i) {
        int v;
        if (pq) {
          if (u16(&v)) return kCorrupt;
        } else {
          uint8_t b;
          if (u8(&b)) return kCorrupt;
          v = b;
        }
        qt[tq][kNaturalOrder[i]] = static_cast<uint16_t>(v);
      }
      qt_defined[tq] = true;
    }
    return pos == seg_end ? kOk : kCorrupt;
  }

  int read_dht() {
    size_t seg_end;
    if (segment(&seg_end) != kOk) return kCorrupt;
    while (pos < seg_end) {
      uint8_t tc_th;
      if (u8(&tc_th)) return kCorrupt;
      const int tc = tc_th >> 4, th = tc_th & 15;
      if (tc > 1 || th > 3) return kCorrupt;
      uint8_t bits[17] = {0};
      int count = 0;
      for (int l = 1; l <= 16; ++l) {
        if (u8(&bits[l])) return kCorrupt;
        count += bits[l];
      }
      if (count > 256 || pos + count > seg_end) return kCorrupt;
      uint8_t vals[256];
      for (int i = 0; i < count; ++i) vals[i] = byte_at(pos + i);
      const int rc = build_huffman(bits, vals, count, tc ? &ac[th] : &dc[th]);
      if (rc != kOk) return rc;
      pos += count;
    }
    return pos == seg_end ? kOk : kCorrupt;
  }

  int read_app(int marker) {
    size_t seg_end;
    if (segment(&seg_end) != kOk) return kCorrupt;
    const size_t n = std::min(seg_end, std::max(size, pos)) - pos;
    const uint8_t* d = data + std::min(pos, size);
    if (marker == 0xE0 && n >= 5 && std::memcmp(d, "JFIF\0", 5) == 0) {
      jfif = true;
    }
    if (marker == 0xEE && n >= 12 && std::memcmp(d, "Adobe", 5) == 0) {
      adobe = true;
      adobe_transform = d[11];
    }
    pos = seg_end;
    return kOk;
  }

  // jdapimin.c default_decompress_parms: is a 3-component frame YCbCr?
  bool is_ycbcr() const {
    if (jfif) return true;
    if (adobe) return adobe_transform != 0;
    const Component* c = info.comp;
    return !(c[0].id == 82 && c[1].id == 71 && c[2].id == 66);  // 'R' 'G' 'B'
  }

  // A sequential Huffman block (jdhuff.c decode_mcu): the DC difference
  // onto the component's prediction, then the AC run/size codes.
  int decode_block(BitReader* br, const Huffman& dct, const Huffman& act,
                   int* pred, int16_t* block) {
    int s = huff_decode(br, dct);
    if (s < 0 || s > 11) return kCorrupt;
    int diff = s ? extend(br->get(s), s) : 0;
    *pred += diff;
    int16_t tmp[64] = {0};
    tmp[0] = static_cast<int16_t>(*pred);
    for (int k = 1; k < 64; ++k) {
      const int rs = huff_decode(br, act);
      if (rs < 0) return kCorrupt;
      const int r = rs >> 4;
      s = rs & 15;
      if (s) {
        k += r;
        if (k > 63) return kCorrupt;
        tmp[kNaturalOrder[k]] = static_cast<int16_t>(extend(br->get(s), s));
      } else {
        if (r != 15) break;  // EOB
        k += 15;             // ZRL
      }
    }
    std::memcpy(block, tmp, sizeof(tmp));
    return kOk;
  }

  // jdphuff.c decode_mcu_DC_first, one block: the difference's category
  // and bits onto the prediction, shifted up by Al.
  int dc_first(BitReader* br, const Huffman& t, int al, int* pred,
               int16_t* block) {
    int s = huff_decode(br, t);
    if (s < 0 || s > 15) return kCorrupt;  // jdhuff.c: DC symbols <= 15
    if (s) s = extend(br->get(s), s);
    *pred += s;
    block[0] = static_cast<int16_t>(static_cast<unsigned>(*pred) << al);
    return kOk;
  }

  // jdphuff.c decode_mcu_AC_first: band Ss..Se of one block, or one block
  // of an EOB run.
  int ac_first(BitReader* br, const Huffman& t, int ss, int se, int al,
               unsigned* eobrun, int16_t* block) {
    if (*eobrun > 0) {
      --*eobrun;
      return kOk;
    }
    for (int k = ss; k <= se; ++k) {
      int s = huff_decode(br, t);
      if (s < 0) return kCorrupt;
      int r = s >> 4;
      s &= 15;
      if (s) {
        k += r;
        s = extend(br->get(s), s);
        block[kNaturalOrder[k]] =
            static_cast<int16_t>(static_cast<unsigned>(s) << al);
      } else if (r == 15) {
        k += 15;  // ZRL
      } else {    // EOBr: a run of 2^r + r bits blocks, this one included
        *eobrun = 1u << r;
        if (r) *eobrun += br->get(r);
        --*eobrun;
        break;
      }
    }
    return kOk;
  }

  // jdphuff.c decode_mcu_AC_refine: one more bit (Al) of band Ss..Se.  A
  // newly nonzero coefficient is +-2^Al; each coefficient already nonzero
  // on the way takes a correction bit that moves it away from zero.
  int ac_refine(BitReader* br, const Huffman& t, int ss, int se, int al,
                unsigned* eobrun, int16_t* block) {
    const int p1 = 1 << al, m1 = -1 * (1 << al);
    int k = ss;
    auto correct = [&](int16_t* coef) {
      if (br->get(1) && (*coef & p1) == 0) {
        *coef = static_cast<int16_t>(*coef >= 0 ? *coef + p1 : *coef + m1);
      }
    };
    if (*eobrun == 0) {
      for (; k <= se; ++k) {
        int s = huff_decode(br, t);
        if (s < 0) return kCorrupt;
        int r = s >> 4;
        s &= 15;
        if (s) {  // a new coefficient, of size 1 (libjpeg warns otherwise)
          s = br->get(1) ? p1 : m1;
        } else if (r != 15) {
          *eobrun = 1u << r;
          if (r) *eobrun += br->get(r);
          break;  // the rest of the block is the EOB run's
        }
        // skip r zero coefficients (and the nonzero ones between them,
        // each corrected), stopping on the zero that becomes s
        do {
          int16_t* coef = block + kNaturalOrder[k];
          if (*coef != 0) {
            correct(coef);
          } else if (--r < 0) {
            break;
          }
          ++k;
        } while (k <= se);
        if (s) block[kNaturalOrder[k]] = static_cast<int16_t>(s);
      }
    }
    if (*eobrun > 0) {
      // the band past the last new coefficient: corrections only
      for (; k <= se; ++k) {
        int16_t* coef = block + kNaturalOrder[k];
        if (*coef != 0) correct(coef);
      }
      --*eobrun;
    }
    return kOk;
  }

  // jdarith.c's DC decode of one block (decode_mcu, decode_mcu_DC_first):
  // the difference under the component's conditioning context, onto its
  // prediction (kept to 16 bits); false on an overflowing code.
  bool arith_dc(ArithReader* ar, ArithStats* st, int tbl, int* context,
                int* pred) {
    uint8_t* bin = st->dc[tbl] + *context;
    if (ar->decode(bin) == 0) {
      *context = 0;
      return true;
    }
    const int sign = ar->decode(bin + 1);
    int v, m;
    if (!arith_magnitude(ar, bin + 2 + sign, st->dc[tbl] + 20, false, sign,
                         &v, &m)) {
      return false;
    }
    // F.1.4.4.1.2: the next difference's conditioning category
    if (m < ((1 << dc_l[tbl]) >> 1)) {
      *context = 0;
    } else if (m > ((1 << dc_u[tbl]) >> 1)) {
      *context = 12 + sign * 4;
    } else {
      *context = 4 + sign * 4;
    }
    *pred = (*pred + v) & 0xFFFF;
    return true;
  }

  // jdarith.c's AC decode of band ss..se (decode_mcu, decode_mcu_AC_first),
  // each value shifted up by al; false on an overflowing code.
  bool arith_ac(ArithReader* ar, ArithStats* st, int tbl, int ss, int se,
                int al, int16_t* block) {
    for (int k = ss; k <= se; ++k) {
      uint8_t* bin = st->ac[tbl] + 3 * (k - 1);
      if (ar->decode(bin)) break;  // EOB
      while (ar->decode(bin + 1) == 0) {
        bin += 3;
        if (++k > se) return false;  // spectral overflow
      }
      const int sign = ar->decode(&st->fixed_bin);
      int v, m;
      if (!arith_magnitude(ar, bin + 2,
                           st->ac[tbl] + (k <= ac_k[tbl] ? 189 : 217), true,
                           sign, &v, &m)) {
        return false;
      }
      block[kNaturalOrder[k]] =
          static_cast<int16_t>(static_cast<unsigned>(v) << al);
    }
    return true;
  }

  // jdarith.c decode_mcu_AC_refine: one more bit (Al) of band ss..se; past
  // the previous stage's last nonzero coefficient an EOB may end it.
  bool arith_ac_refine(ArithReader* ar, ArithStats* st, int tbl, int ss,
                       int se, int al, int16_t* block) {
    const int p1 = 1 << al, m1 = -1 * (1 << al);
    int kex = se;
    for (; kex > 0; --kex) {
      if (block[kNaturalOrder[kex]]) break;
    }
    for (int k = ss; k <= se; ++k) {
      uint8_t* bin = st->ac[tbl] + 3 * (k - 1);
      if (k > kex && ar->decode(bin)) break;  // EOB
      for (;;) {
        int16_t* coef = block + kNaturalOrder[k];
        if (*coef) {  // previously nonzero: a correction bit
          if (ar->decode(bin + 2)) {
            *coef = static_cast<int16_t>(*coef < 0 ? *coef + m1 : *coef + p1);
          }
          break;
        }
        if (ar->decode(bin + 1)) {  // newly nonzero
          *coef = static_cast<int16_t>(ar->decode(&st->fixed_bin) ? m1 : p1);
          break;
        }
        bin += 3;
        if (++k > se) return false;  // spectral overflow
      }
    }
    return true;
  }

  int read_scan() {
    if (!have_sof) return kCorrupt;
    size_t seg_end;
    if (segment(&seg_end) != kOk) return kCorrupt;
    uint8_t ns;
    if (u8(&ns) || ns < 1 || ns > info.ncomp) return kCorrupt;
    int sc[kMaxComps], td[kMaxComps], ta[kMaxComps];
    for (int i = 0; i < ns; ++i) {
      uint8_t id, t;
      if (u8(&id) || u8(&t)) return kCorrupt;
      sc[i] = -1;
      for (int c = 0; c < info.ncomp; ++c) {
        if (info.comp[c].id == id) sc[i] = c;
      }
      if (sc[i] < 0) return kCorrupt;
      td[i] = t >> 4;
      ta[i] = t & 15;
    }
    uint8_t ss_u8, se_u8, ah_al;
    if (u8(&ss_u8) || u8(&se_u8) || u8(&ah_al)) return kCorrupt;
    const int ss = ss_u8, se = se_u8, ah = ah_al >> 4, al = ah_al & 15;
    if (pos != seg_end) return kCorrupt;
    ++scans;
    const bool dc_band = ss == 0;
    if (progressive) {
      // jdphuff.c / jdarith.c start_pass: parameters libjpeg rejects
      if ((dc_band && se != 0) ||
          (!dc_band && (se < ss || se > 63 || ns != 1)) ||
          (ah != 0 && al != ah - 1) || al > 13) {
        return kProgressive;
      }
      for (int i = 0; i < ns; ++i) {
        int* bits = coef_bits[sc[i]];
        for (int k = std::min(ss, 1); k <= std::max(se, 9); ++k) {
          prev_bits[sc[i]][k] = scans > 1 ? bits[k] : 0;
        }
        for (int k = ss; k <= se; ++k) bits[k] = al;
      }
    }
    // the tables the scan reads: Huffman sequential both; progressive DC
    // first its DC table, AC its AC table, DC refine none
    const bool need_dc = !progressive || (dc_band && ah == 0);
    const bool need_ac = !progressive || !dc_band;
    if (!arithmetic) {
      for (int i = 0; i < ns; ++i) {
        if ((need_dc && (td[i] > 3 || !dc[td[i]].defined)) ||
            (need_ac && (ta[i] > 3 || !ac[ta[i]].defined))) {
          return kCorrupt;
        }
      }
    }
    for (int i = 0; i < ns; ++i) {  // jdinput.c latch_quant_tables
      const int c = sc[i];
      if (!latched[c]) {
        if (!qt_defined[info.comp[c].tq]) return kCorrupt;
        std::memcpy(qt_out[c], qt[info.comp[c].tq], sizeof(qt[0]));
        latched[c] = true;
      }
    }
    // the MCU grid: one block of the component (non-interleaved) or each
    // component's h x v blocks (interleaved)
    int mcus_w, mcus_h;
    if (ns == 1) {
      mcus_w = info.comp[sc[0]].blocks_w;
      mcus_h = info.comp[sc[0]].blocks_h;
    } else {
      mcus_w = (info.width + 8 * info.max_h - 1) / (8 * info.max_h);
      mcus_h = (info.height + 8 * info.max_v - 1) / (8 * info.max_v);
    }
    BitReader br{data + pos, data + size};
    ArithReader ar{data + pos, data + size};
    ArithStats stats;
    // a scan's statistics start at zero (jdarith.c start_pass, and again
    // at each restart)
    auto zero_stats = [&] {
      for (int i = 0; i < ns; ++i) {
        if (need_dc) std::memset(stats.dc[td[i]], 0, sizeof(stats.dc[0]));
        if (!progressive || !dc_band) {
          std::memset(stats.ac[ta[i]], 0, sizeof(stats.ac[0]));
        }
      }
    };
    if (arithmetic) zero_stats();
    int pred[kMaxComps] = {0, 0, 0}, context[kMaxComps] = {0, 0, 0};
    unsigned eobrun = 0;
    int restarts_to_go = restart_interval;
    int next_rst = 0;
    // a Huffman MCU ran past the data: the scan's later MCUs are skipped
    // until a restart marker is swallowed (jdhuff.c insufficient_data)
    bool insufficient = false;
    int16_t dummy[64];
    for (int my = 0; my < mcus_h; ++my) {
      // jdcoefct.c consume_data: the iMCU row of this MCU row
      const int imcu_row = ns == 1 ? my / info.comp[sc[0]].v_samp : my;
      for (int mx = 0; mx < mcus_w; ++mx) {
        if (!insufficient) last_good = imcu_row;
        if (restart_interval) {
          if (restarts_to_go == 0) {  // process_restart
            if (arithmetic) {
              if (!ar.unread_marker) {
                ar.marker_at = find_marker(ar.p, ar.end);
              }
              const uint8_t* resume =
                  resync_to_restart(&ar.marker_at, ar.end, next_rst);
              if (resume != nullptr) {
                ar.p = resume;
                ar.unread_marker = 0;
              } else {
                ar.unread_marker = marker_code(ar.marker_at, ar.end);
              }
              ar.reset();
              zero_stats();
            } else {
              br.to_marker();
              const uint8_t* at = br.p;
              const uint8_t* resume = resync_to_restart(&at, br.end, next_rst);
              if (resume != nullptr) {
                br.p = resume;
                br.at_marker = false;
                insufficient = false;
              } else {
                br.p = at;
              }
            }
            next_rst = (next_rst + 1) & 7;
            restarts_to_go = restart_interval;
            for (int i = 0; i < kMaxComps; ++i) pred[i] = context[i] = 0;
            eobrun = 0;
          }
          --restarts_to_go;
        }
        if (insufficient) continue;
        for (int i = 0; i < ns; ++i) {
          const int c = sc[i];
          const Component& cp = info.comp[c];
          const int bh = ns == 1 ? 1 : cp.v_samp;
          const int bw = ns == 1 ? 1 : cp.h_samp;
          for (int v = 0; v < bh; ++v) {
            for (int h = 0; h < bw; ++h) {
              const int by = my * bh + v, bx = mx * bw + h;
              int16_t* block = dummy;  // a dummy block past the edge
              if (by < cp.blocks_h && bx < cp.blocks_w) {
                block = coefs[c] +
                        (static_cast<size_t>(by) * cp.blocks_w + bx) * 64;
              }
              if (arithmetic) {
                if (ar.ct == -1) continue;  // an overflowed code: skip
                bool ok = true;
                if (!progressive) {
                  std::memset(block, 0, sizeof(dummy));
                  ok = arith_dc(&ar, &stats, td[i], &context[i], &pred[i]);
                  if (ok) {
                    block[0] = static_cast<int16_t>(pred[i]);
                    ok = arith_ac(&ar, &stats, ta[i], 1, 63, 0, block);
                  }
                } else if (dc_band && ah == 0) {
                  ok = arith_dc(&ar, &stats, td[i], &context[i], &pred[i]);
                  if (ok) {
                    block[0] = static_cast<int16_t>(
                        static_cast<unsigned>(pred[i]) << al);
                  }
                } else if (dc_band) {
                  if (ar.decode(&stats.fixed_bin)) block[0] |= 1 << al;
                } else if (ah == 0) {
                  ok = arith_ac(&ar, &stats, ta[i], ss, se, al, block);
                } else {
                  ok = arith_ac_refine(&ar, &stats, ta[i], ss, se, al, block);
                }
                if (!ok) ar.ct = -1;  // JWRN_ARITH_BAD_CODE
                continue;
              }
              int rc;
              if (!progressive) {
                rc = decode_block(&br, dc[td[i]], ac[ta[i]], &pred[i], block);
              } else if (dc_band && ah == 0) {
                rc = dc_first(&br, dc[td[i]], al, &pred[i], block);
              } else if (dc_band) {
                if (br.get(1)) block[0] |= 1 << al;
                rc = kOk;
              } else if (ah == 0) {
                rc = ac_first(&br, ac[ta[i]], ss, se, al, &eobrun, block);
              } else {
                rc = ac_refine(&br, ac[ta[i]], ss, se, al, &eobrun, block);
              }
              if (rc != kOk) return rc;
            }
          }
        }
        if (br.hit) {  // this MCU took zero bits past the data
          insufficient = true;
          br.hit = false;
        }
      }
    }
    if (arithmetic) {
      pos = static_cast<size_t>(
          (ar.unread_marker ? ar.marker_at : find_marker(ar.p, ar.end)) -
          data);
    } else {
      br.to_marker();
      pos = static_cast<size_t>(br.p - data);
    }
    return kOk;
  }

  // jdcoefct.c smoothing_ok at the output pass: libjpeg smooths a
  // progressive frame's blocks when every component's DC is known, its
  // table's first ten quantizers are nonzero, and one of coefficients
  // 1..9 of some component is not fully refined (or never coded).
  void latch_smoothing(Smoothing* sm) const {
    static constexpr int kQ[10] = {0, 1, 8, 16, 9, 2, 3, 10, 17, 24};
    sm->apply = false;
    sm->last_good = last_good;
    for (int c = 0; c < info.ncomp; ++c) {
      for (int k = 0; k < kSavedCoefs; ++k) {
        sm->bits[c][k] = coef_bits[c][k];
        sm->prev[c][k] = k == 0 ? coef_bits[c][0]
                         : scans > 1 ? prev_bits[c][k] : -1;
      }
    }
    if (!progressive) return;
    bool useful = false;
    for (int c = 0; c < info.ncomp; ++c) {
      if (!latched[c] || coef_bits[c][0] < 0) return;
      for (int q : kQ) {
        if (qt_out[c][q] == 0) return;
      }
      for (int k = 1; k < kSavedCoefs; ++k) {
        if (coef_bits[c][k] != 0) useful = true;
      }
    }
    sm->apply = useful;
  }

  // Markers up to the first SOS (headers only, `coefs` unset), or the whole
  // stream.
  int run(bool headers_only) {
    int marker;
    if (size < 2 || data[0] != 0xFF || data[1] != 0xD8) return kCorrupt;
    pos = 2;
    bool scanned = false;
    while (true) {
      if (next_marker(&marker) != kOk) marker = 0xD9;  // a missing EOI
      int rc = kOk;
      size_t seg_end;
      switch (marker) {
        case 0xC0: case 0xC1: case 0xC2: case 0xC3: case 0xC5: case 0xC6:
        case 0xC7: case 0xC8: case 0xC9: case 0xCA: case 0xCB: case 0xCD:
        case 0xCE: case 0xCF:
          rc = read_sof(marker);
          break;
        case 0xCC:
          rc = read_dac();
          break;
        case 0xC4:
          rc = read_dht();
          break;
        case 0xDB:
          rc = read_dqt();
          break;
        case 0xDD: {
          int ri;
          if (segment(&seg_end) || u16(&ri)) return kCorrupt;
          restart_interval = ri;
          pos = seg_end;
          break;
        }
        case 0xDA:
          if (!have_sof) return kCorrupt;
          if (info.ncomp == 3 && !is_ycbcr()) return kColorSpace;
          if (headers_only) return kOk;
          rc = read_scan();
          scanned = true;
          break;
        case 0xD9:  // EOI
          if (!scanned) return kCorrupt;
          for (int c = 0; c < info.ncomp; ++c) {
            // a component never coded: zero blocks, no table (libjpeg's
            // multiplier table stays zero), a flat 128 plane
            if (!latched[c] && qt_out[c] != nullptr) {
              std::memset(qt_out[c], 0, sizeof(qt[0]));
            }
          }
          return kOk;
        case 0xD8:
          return kCorrupt;
        default:
          // a stray RSTn, TEM: no segment
          if ((marker >= 0xD0 && marker <= 0xD7) || marker == 0x01) break;
          if ((marker >= 0xE0 && marker <= 0xEF) || marker == 0xFE) {
            rc = read_app(marker);
          } else if (marker == 0xDC) {
            rc = kCorrupt;  // DNL: heights from the scan are not taken
          } else {
            if (segment(&seg_end) != kOk) return kCorrupt;
            pos = seg_end;
          }
      }
      if (rc != kOk) return rc;
    }
  }
};

int read_file(const char* path, std::vector<uint8_t>* out) {
  FILE* fh = std::fopen(path, "rb");
  if (!fh) return kNoFile;
  std::fseek(fh, 0, SEEK_END);
  const long size = std::ftell(fh);
  std::fseek(fh, 0, SEEK_SET);
  if (size <= 0) {
    std::fclose(fh);
    return kCorrupt;
  }
  out->resize(static_cast<size_t>(size));
  const size_t got = std::fread(out->data(), 1, out->size(), fh);
  std::fclose(fh);
  return got == out->size() ? kOk : kCorrupt;
}

// A frame's headers (through its first SOS).
int read_info(const uint8_t* data, size_t size, Info* info) {
  Decoder d(data, size);
  const int rc = d.run(true);
  if (rc == kOk) *info = d.info;
  return rc;
}

// A frame's coefficients into coefs[c] ((blocks_h, blocks_w, 64) int16 of
// the geometry `info` gave, unsmoothed) and qtables[c] (64 uint16, natural
// order), and its smoothing latch into *sm.
int decode_coefs(const uint8_t* data, size_t size, const Info& info,
                 int16_t* const* coefs, uint16_t* const* qtables,
                 Smoothing* sm) {
  Decoder d(data, size);
  for (int c = 0; c < info.ncomp; ++c) {
    d.coefs[c] = coefs[c];
    d.qt_out[c] = qtables[c];
  }
  const int rc = d.run(false);
  if (rc != kOk) return rc;
  // the frame must be the one `info` described
  if (d.info.width != info.width || d.info.height != info.height ||
      d.info.ncomp != info.ncomp) {
    return kCorrupt;
  }
  for (int c = 0; c < info.ncomp; ++c) {
    if (d.info.comp[c].h_samp != info.comp[c].h_samp ||
        d.info.comp[c].v_samp != info.comp[c].v_samp) {
      return kCorrupt;
    }
  }
  d.latch_smoothing(sm);
  return kOk;
}

// jdcoefct.c decompress_smooth_data's coefficient half (libjpeg-turbo
// 2.1.5) on one component: `in` its unsmoothed (blocks_h, blocks_w, 64)
// blocks, `out` the smoothed ones (never `in`: every estimate reads its
// neighbours' unsmoothed DC values), `bits` its coef_bits[0..9] latch,
// `prev_bits` the latch's second row, which the iMCU rows past
// `last_good` (the frame's last good iMCU row) read in its place, `qt`
// its latched table (natural order).  A block's coefficient k in
// 1..9 (zigzag) that is still zero and not known to full precision
// (coef_bits[k] != 0) is estimated from the DC values of the 5x5 blocks
// around it, clamped below 2^Al; with no AC coefficient of 1..9 ever coded
// (every coef_bits[k] == -1) a Gaussian-like kernel estimates them all and
// the DC too.  libjpeg walks the blocks by iMCU rows of v_samp block rows,
// and its neighbours follow that walk literally: the rows two above and
// two below are replaced by the nearer row within the first two and the
// last two iMCU rows, and a column register that no block past the right
// edge refreshes keeps the first column's DC (images 2 blocks wide).
void smooth_component(const int16_t* in, int16_t* out, int blocks_h,
                      int blocks_w, int v_samp, int imcu_rows,
                      const uint16_t* qt, const int* latch_bits,
                      const int* prev_bits, int last_good) {
  // natural positions of zigzag coefficients 1..9
  constexpr int kPos[kSavedCoefs] = {0, 1, 8, 16, 9, 2, 3, 10, 17, 24};
  int64_t q[kSavedCoefs];
  for (int k = 0; k < kSavedCoefs; ++k) q[k] = qt[kPos[k]];
  const int* bits = latch_bits;
  bool change_dc = true;
  // ((Q << 7) + |num|) / (Q << 8), clamped below 2^Al when Al > 0, signed
  auto estimate = [&](int k, int64_t num, bool clamp) {
    const int al = bits[k];
    int pred = static_cast<int>(((q[k] << 7) + (num >= 0 ? num : -num)) /
                                (q[k] << 8));
    if (clamp && al > 0 && pred >= (1 << al)) pred = (1 << al) - 1;
    return static_cast<int16_t>(num >= 0 ? pred : -pred);
  };
  const size_t row_stride = static_cast<size_t>(blocks_w) * 64;
  const int last_imcu = imcu_rows - 1;
  for (int imcu = 0; imcu < imcu_rows; ++imcu) {
    // an incomplete last scan: the rows past the last good one read the
    // coefficient bits from before it
    bits = imcu > last_good ? prev_bits : latch_bits;
    change_dc = true;
    for (int k = 1; k < kSavedCoefs; ++k) {
      change_dc = change_dc && bits[k] == -1;
    }
    int block_rows = v_samp;
    if (imcu == last_imcu) {
      block_rows = blocks_h % v_samp;
      if (block_rows == 0) block_rows = v_samp;
    }
    for (int br = 0; br < block_rows; ++br) {
      const int r = imcu * v_samp + br;
      const int prev = (br > 0 || imcu > 0) ? r - 1 : r;
      const int prev_prev = (br > 1 || imcu > 1) ? r - 2 : prev;
      const int next = (br < block_rows - 1 || imcu < last_imcu) ? r + 1 : r;
      const int next_next =
          (br < block_rows - 2 || imcu + 1 < last_imcu) ? r + 2 : next;
      const int16_t* rows[5] = {in + prev_prev * row_stride,
                                in + prev * row_stride, in + r * row_stride,
                                in + next * row_stride,
                                in + next_next * row_stride};
      // dc[i][j]: DC(i*5 + j + 1) of libjpeg's sliding registers, rows
      // two above .. two below, columns two left .. two right
      int dc[5][5];
      for (int i = 0; i < 5; ++i) {
        for (int j = 0; j < 5; ++j) dc[i][j] = rows[i][0];
      }
      const int last_col = blocks_w - 1;
      for (int b = 0; b < blocks_w; ++b) {
        if (b == 0 && b < last_col) {
          for (int i = 0; i < 5; ++i) dc[i][3] = rows[i][64];
        }
        if (b + 1 < last_col) {
          for (int i = 0; i < 5; ++i) dc[i][4] = rows[i][(b + 2) * 64];
        }
        int16_t* w = out + r * row_stride + static_cast<size_t>(b) * 64;
        std::memcpy(w, in + r * row_stride + static_cast<size_t>(b) * 64,
                    64 * sizeof(int16_t));
        const int DC01 = dc[0][0], DC02 = dc[0][1], DC03 = dc[0][2],
                  DC04 = dc[0][3], DC05 = dc[0][4], DC06 = dc[1][0],
                  DC07 = dc[1][1], DC08 = dc[1][2], DC09 = dc[1][3],
                  DC10 = dc[1][4], DC11 = dc[2][0], DC12 = dc[2][1],
                  DC13 = dc[2][2], DC14 = dc[2][3], DC15 = dc[2][4],
                  DC16 = dc[3][0], DC17 = dc[3][1], DC18 = dc[3][2],
                  DC19 = dc[3][3], DC20 = dc[3][4], DC21 = dc[4][0],
                  DC22 = dc[4][1], DC23 = dc[4][2], DC24 = dc[4][3],
                  DC25 = dc[4][4];
        const int64_t q00 = q[0];
        if (bits[1] != 0 && w[1] == 0) {  // AC01
          w[1] = estimate(1, q00 * (change_dc ?
              (-DC01 - DC02 + DC04 + DC05 - 3 * DC06 + 13 * DC07 -
               13 * DC09 + 3 * DC10 - 3 * DC11 + 38 * DC12 - 38 * DC14 +
               3 * DC15 - 3 * DC16 + 13 * DC17 - 13 * DC19 + 3 * DC20 -
               DC21 - DC22 + DC24 + DC25) :
              (-7 * DC11 + 50 * DC12 - 50 * DC14 + 7 * DC15)), true);
        }
        if (bits[2] != 0 && w[8] == 0) {  // AC10
          w[8] = estimate(2, q00 * (change_dc ?
              (-DC01 - 3 * DC02 - 3 * DC03 - 3 * DC04 - DC05 - DC06 +
               13 * DC07 + 38 * DC08 + 13 * DC09 - DC10 + DC16 -
               13 * DC17 - 38 * DC18 - 13 * DC19 + DC20 + DC21 +
               3 * DC22 + 3 * DC23 + 3 * DC24 + DC25) :
              (-7 * DC03 + 50 * DC08 - 50 * DC18 + 7 * DC23)), true);
        }
        if (bits[3] != 0 && w[16] == 0) {  // AC20
          w[16] = estimate(3, q00 * (change_dc ?
              (DC03 + 2 * DC07 + 7 * DC08 + 2 * DC09 - 5 * DC12 -
               14 * DC13 - 5 * DC14 + 2 * DC17 + 7 * DC18 + 2 * DC19 +
               DC23) :
              (-DC03 + 13 * DC08 - 24 * DC13 + 13 * DC18 - DC23)), true);
        }
        if (bits[4] != 0 && w[9] == 0) {  // AC11
          w[9] = estimate(4, q00 * (change_dc ?
              (-DC01 + DC05 + 9 * DC07 - 9 * DC09 - 9 * DC17 + 9 * DC19 +
               DC21 - DC25) :
              (DC10 + DC16 - 10 * DC17 + 10 * DC19 - DC02 - DC20 + DC22 -
               DC24 + DC04 - DC06 + 10 * DC07 - 10 * DC09)), true);
        }
        if (bits[5] != 0 && w[2] == 0) {  // AC02
          w[2] = estimate(5, q00 * (change_dc ?
              (2 * DC07 - 5 * DC08 + 2 * DC09 + DC11 + 7 * DC12 -
               14 * DC13 + 7 * DC14 + DC15 + 2 * DC17 - 5 * DC18 +
               2 * DC19) :
              (-DC11 + 13 * DC12 - 24 * DC13 + 13 * DC14 - DC15)), true);
        }
        if (change_dc) {
          if (bits[6] != 0 && w[3] == 0) {  // AC03
            w[3] = estimate(6, q00 * (DC07 - DC09 + 2 * DC12 - 2 * DC14 +
                                      DC17 - DC19), true);
          }
          if (bits[7] != 0 && w[10] == 0) {  // AC12
            w[10] = estimate(7, q00 * (DC07 - 3 * DC08 + DC09 - DC17 +
                                       3 * DC18 - DC19), true);
          }
          if (bits[8] != 0 && w[17] == 0) {  // AC21
            w[17] = estimate(8, q00 * (DC07 - DC09 - 3 * DC12 + 3 * DC14 +
                                       DC17 - DC19), true);
          }
          if (bits[9] != 0 && w[24] == 0) {  // AC30
            w[24] = estimate(9, q00 * (DC07 + 2 * DC08 + DC09 - DC17 -
                                       2 * DC18 - DC19), true);
          }
          w[0] = estimate(0, q00 * (
              -2 * DC01 - 6 * DC02 - 8 * DC03 - 6 * DC04 - 2 * DC05 -
              6 * DC06 + 6 * DC07 + 42 * DC08 + 6 * DC09 - 6 * DC10 -
              8 * DC11 + 42 * DC12 + 152 * DC13 + 42 * DC14 - 8 * DC15 -
              6 * DC16 + 6 * DC17 + 42 * DC18 + 6 * DC19 - 6 * DC20 -
              2 * DC21 - 6 * DC22 - 8 * DC23 - 6 * DC24 - 2 * DC25), false);
        }
        for (int i = 0; i < 5; ++i) {  // the registers slide one column
          for (int j = 0; j < 4; ++j) dc[i][j] = dc[i][j + 1];
        }
      }
    }
  }
}

// A frame's blocks smoothed as libjpeg smooths them at output, where *sm
// says it does: each component's `coefs[c]` (unsmoothed) into `out[c]`.
void smooth_frame(const Info& info, const int16_t* const* coefs,
                  int16_t* const* out, const uint16_t* const* qtables,
                  const Smoothing& sm) {
  for (int c = 0; c < info.ncomp; ++c) {
    const Component& cp = info.comp[c];
    smooth_component(coefs[c], out[c], cp.blocks_h, cp.blocks_w, cp.v_samp,
                     info.imcu_rows(), qtables[c], sm.bits[c], sm.prev[c],
                     sm.last_good);
  }
}

// Parallel-for over items with a transient thread pool; the first error
// any item returns.
template <typename Fn>
int parallel_for(int n, int n_threads, Fn&& fn) {
  if (n_threads < 1) n_threads = 1;
  std::atomic<int> next(0), err(0);
  auto worker = [&] {
    int i;
    while ((i = next.fetch_add(1)) < n) {
      const int rc = fn(i);
      int expected = 0;
      if (rc != 0) err.compare_exchange_strong(expected, rc);
    }
  };
  std::vector<std::thread> threads;
  const int spawn = n_threads < n ? n_threads : n;
  for (int t = 1; t < spawn; ++t) threads.emplace_back(worker);
  worker();
  for (auto& th : threads) th.join();
  return err.load();
}

// The ints ammc_jpeg_info writes: width, height, ncomp, then per component
// (kMaxComps of them) h_samp, v_samp, width, height, blocks_w, blocks_h;
// then the frame's iMCU rows.
constexpr int kInfoInts = 3 + 6 * kMaxComps + 1;
// The ints of a frame's smoothing latch (ammc_jpeg_coefs_video): whether
// libjpeg smooths it, its last good iMCU row, then per component its
// coef_bits[0..9], then per component the latch's second row.
constexpr int kLatchInts = 2 + 2 * kSavedCoefs * kMaxComps;

void pack_info(const Info& info, int* out) {
  std::memset(out, 0, sizeof(int) * kInfoInts);
  out[0] = info.width;
  out[1] = info.height;
  out[2] = info.ncomp;
  for (int c = 0; c < info.ncomp; ++c) {
    const Component& cp = info.comp[c];
    int* o = out + 3 + 6 * c;
    o[0] = cp.h_samp;
    o[1] = cp.v_samp;
    o[2] = cp.width;
    o[3] = cp.height;
    o[4] = cp.blocks_w;
    o[5] = cp.blocks_h;
  }
  out[3 + 6 * kMaxComps] = info.imcu_rows();
}

}  // namespace ammc_jpeg

extern "C" {

// A JPEG file's geometry: kInfoInts ints (above).  Returns 0 or an error
// code.
int ammc_jpeg_info(const char* path, int* out) {
  std::vector<uint8_t> data;
  int rc = ammc_jpeg::read_file(path, &data);
  if (rc != 0) return rc;
  ammc_jpeg::Info info;
  rc = ammc_jpeg::read_info(data.data(), data.size(), &info);
  if (rc == 0) ammc_jpeg::pack_info(info, out);
  return rc;
}

// n JPEG files' coefficients, unsmoothed, on n_threads threads: coefs[i *
// 3 + c] points at frame i's component c, (blocks_h, blocks_w, 64) int16
// as ammc_jpeg_info gave them, qtables at n * 3 * 64 uint16 (frame i's
// component c at (i * 3 + c) * 64), latch at n * kLatchInts ints (frame
// i's at i * kLatchInts: 1 if libjpeg smooths it at output, else 0, its
// last good iMCU row, per component its coef_bits[0..9], then per
// component the second row).  Returns 0 or the first error code.
int ammc_jpeg_coefs_video(const char** paths, int n, int n_threads,
                          int16_t** coefs, uint16_t* qtables, int* latch) {
  return ammc_jpeg::parallel_for(n, n_threads, [&](int i) {
    std::vector<uint8_t> data;
    int rc = ammc_jpeg::read_file(paths[i], &data);
    if (rc != 0) return rc;
    ammc_jpeg::Info info;
    rc = ammc_jpeg::read_info(data.data(), data.size(), &info);
    if (rc != 0) return rc;
    uint16_t* qts[ammc_jpeg::kMaxComps];
    for (int c = 0; c < ammc_jpeg::kMaxComps; ++c) {
      qts[c] = qtables + (static_cast<size_t>(i) * 3 + c) * 64;
    }
    ammc_jpeg::Smoothing sm;
    rc = ammc_jpeg::decode_coefs(data.data(), data.size(), info,
                                 coefs + static_cast<size_t>(i) * 3, qts,
                                 &sm);
    if (rc != 0) return rc;
    int* out = latch + static_cast<size_t>(i) * ammc_jpeg::kLatchInts;
    std::memset(out, 0, sizeof(int) * ammc_jpeg::kLatchInts);
    out[0] = sm.apply ? 1 : 0;
    out[1] = sm.last_good;
    for (int c = 0; c < info.ncomp; ++c) {
      std::memcpy(out + 2 + c * ammc_jpeg::kSavedCoefs, sm.bits[c],
                  sizeof(int) * ammc_jpeg::kSavedCoefs);
      std::memcpy(out + 2 + (ammc_jpeg::kMaxComps + c) *
                                ammc_jpeg::kSavedCoefs,
                  sm.prev[c], sizeof(int) * ammc_jpeg::kSavedCoefs);
    }
    return 0;
  });
}

// One component's blocks smoothed as libjpeg smooths them (above,
// smooth_component): in and out (blocks_h, blocks_w, 64) int16, distinct;
// v_samp its vertical sampling factor; imcu_rows the frame's iMCU rows;
// qtable its 64 quantizers (natural order); coef_bits its 10 latched
// values, prev_bits the latch's second row, which the iMCU rows past
// last_good read.  Returns 0.
int ammc_jpeg_smooth(const int16_t* in, int16_t* out, int blocks_h,
                     int blocks_w, int v_samp, int imcu_rows,
                     const uint16_t* qtable, const int* coef_bits,
                     const int* prev_bits, int last_good) {
  ammc_jpeg::smooth_component(in, out, blocks_h, blocks_w, v_samp, imcu_rows,
                              qtable, coef_bits, prev_bits, last_good);
  return 0;
}

}  // extern "C"
