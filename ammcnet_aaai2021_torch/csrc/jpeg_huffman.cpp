// The entropy decode of baseline JPEG frames, without libjpeg: markers,
// Huffman-coded sequential scans, quantized DCT coefficients out.
//
// The GPU route of the port's loader (jpeg_decode.cu, which includes this
// file) runs libjpeg's accurate integer IDCT on the card, so the card's
// frames are bitwise what libjpeg gives on the host (ammc_loader.cpp).  The
// card needs the coefficients for that, and the only JPEG library on its
// machine (nvJPEG) hands out pixels, not coefficients: this file is the
// decode up to the coefficients, in the order libjpeg's jdmarker.c,
// jdhuff.c and jdcoefct.c do it.
//
// It takes: SOI; DQT (8- and 16-bit tables); SOF0 and SOF1 with 8-bit
// samples and 1 or 3 components; DHT; DRI and RSTn; SOS, interleaved and
// non-interleaved (a component's scan then covers its own blocks, not the
// MCU grid); APPn and COM, skipped (APP0 JFIF and APP14 Adobe read for the
// colour space, as jdapimin.c guesses it); EOI.  It refuses, each with its
// own code: progressive (SOF2, SOF6), lossless or hierarchical frames,
// arithmetic coding (SOF9-15, DAC), sample precision other than 8 bits,
// other than 1 or 3 components, a 3-component frame that is not YCbCr.
// There is no fallback: the caller raises on the code.
//
// Per component the decode yields its sampling factors, its downsampled
// size (libjpeg's: ceil(image_w * h_samp / max_h_samp), likewise the
// height), its quantization table in natural order (latched at the
// component's first scan, as jdinput.c latches it) and its blocks,
// (blocks_h, blocks_w, 64) int16 in natural order, blocks_w =
// ceil(width / 8): the blocks libjpeg keeps.  An interleaved scan's dummy
// blocks past the right or bottom edge are decoded and dropped.
//
// A premature marker or the end of the data feeds zero bits, as libjpeg
// does (it warns, JWRN_HIT_MARKER); a restart marker other than the one
// expected is corrupt data (libjpeg resynchronises).
//
// C ABI, built alone with g++ into the "coef" form of the host library
// (ammcnet_aaai2021_torch/data/native.py), no libjpeg:
//   ammc_jpeg_info(path, info[kInfoInts])                  -> 0 | errcode
//   ammc_jpeg_coefs_video(paths, n, threads, coefs, qtables) -> 0 | errcode
// Error codes (data/native.py:ERRORS): 2 a file that does not open, 3
// corrupt data, 8 components other than 1 or 3, 10 progressive, 11
// lossless or hierarchical, 12 arithmetic-coded, 13 sample precision other
// than 8 bits, 14 a 3-component frame coded other than as YCbCr.

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
  kProgressive = 10,
  kLossless = 11,
  kArithmetic = 12,
  kPrecision = 13,
  kColorSpace = 14,
};

constexpr int kMaxComps = 3;

// zigzag position -> natural (row-major) position (jutils.c
// jpeg_natural_order)
constexpr int kNaturalOrder[64] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63};

struct Component {
  int id = 0, h_samp = 1, v_samp = 1, tq = 0;
  int width = 0, height = 0;      // downsampled size
  int blocks_w = 0, blocks_h = 0;  // ceil(size / 8)
};

struct Info {
  int width = 0, height = 0, ncomp = 0, max_h = 1, max_v = 1;
  Component comp[kMaxComps];
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
// unstuffed; at a marker (or the end) it feeds zeros.
struct BitReader {
  const uint8_t* p;
  const uint8_t* end;
  uint64_t buf = 0;
  int bits = 0;
  bool at_marker = false;

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
          } else {
            at_marker = true;  // p stays on the marker's 0xFF
            p = q - 1;
            b = 0;
          }
        } else {
          ++p;
        }
      }
      buf |= static_cast<uint64_t>(b) << (56 - bits);
      bits += 8;
    }
  }
  int get(int n) {  // n <= 16
    if (n == 0) return 0;
    if (bits < n) fill();
    const int v = static_cast<int>(buf >> (64 - n));
    buf <<= n;
    bits -= n;
    return v;
  }
  int peek8() {
    if (bits < 8) fill();
    return static_cast<int>(buf >> 56);
  }
  void skip(int n) {
    buf <<= n;
    bits -= n;
  }
  // Drop the buffered bits and stand on the next marker.
  void to_marker() {
    buf = 0;
    bits = 0;
    if (at_marker) return;
    while (p + 1 < end && !(p[0] == 0xFF && p[1] != 0x00 && p[1] != 0xFF)) {
      ++p;
    }
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

struct Decoder {
  Decoder(const uint8_t* d, size_t n) : data(d), size(n) {}
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
  // output: per component, its latched table and its blocks
  bool latched[kMaxComps] = {false, false, false};
  uint16_t* qt_out[kMaxComps] = {nullptr, nullptr, nullptr};
  int16_t* coefs[kMaxComps] = {nullptr, nullptr, nullptr};

  int u8(uint8_t* v) {
    if (pos >= size) return kCorrupt;
    *v = data[pos++];
    return kOk;
  }
  int u16(int* v) {
    if (pos + 2 > size) return kCorrupt;
    *v = (data[pos] << 8) | data[pos + 1];
    pos += 2;
    return kOk;
  }
  // The next marker code, skipping any bytes before it (jdmarker.c
  // next_marker tolerates them).
  int next_marker(int* marker) {
    while (pos < size && data[pos] != 0xFF) ++pos;
    while (pos < size && data[pos] == 0xFF) ++pos;
    if (pos >= size) return kCorrupt;
    *marker = data[pos++];
    return kOk;
  }
  int segment(size_t* seg_end) {
    int len;
    if (u16(&len) != kOk || len < 2 || pos + len - 2 > size) return kCorrupt;
    *seg_end = pos + len - 2;
    return kOk;
  }

  int read_sof(int marker) {
    // SOF0 baseline, SOF1 extended sequential Huffman; the others refused
    if (marker == 0xC2 || marker == 0xC6) return kProgressive;
    if (marker == 0xC3 || marker == 0xC5 || marker == 0xC7 ||
        marker == 0xCB || marker == 0xCD || marker == 0xCF) {
      // lossless (C3, CB) or hierarchical (C5-C7, CD-CF; arithmetic too)
      return marker >= 0xC8 && marker != 0xCB ? kArithmetic : kLossless;
    }
    if (marker >= 0xC9) return kArithmetic;  // C9, CA: arithmetic sequential
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
      const int rc =
          build_huffman(bits, data + pos, count, tc ? &ac[th] : &dc[th]);
      if (rc != kOk) return rc;
      pos += count;
    }
    return pos == seg_end ? kOk : kCorrupt;
  }

  int read_app(int marker) {
    size_t seg_end;
    if (segment(&seg_end) != kOk) return kCorrupt;
    const uint8_t* d = data + pos;
    const size_t n = seg_end - pos;
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

  int decode_block(BitReader* br, const Huffman& dct, const Huffman& act,
                   int* pred, int16_t* block) {
    // DC: a magnitude category, then its bits (jdhuff.c decode_mcu)
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
    if (block) std::memcpy(block, tmp, sizeof(tmp));
    return kOk;
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
      if (td[i] > 3 || ta[i] > 3 || !dc[td[i]].defined ||
          !ac[ta[i]].defined) {
        return kCorrupt;
      }
    }
    uint8_t ss, se, ah_al;
    if (u8(&ss) || u8(&se) || u8(&ah_al)) return kCorrupt;
    if (ss != 0 || se != 63 || ah_al != 0) return kCorrupt;  // sequential
    pos = seg_end;
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
    int pred[kMaxComps] = {0, 0, 0};
    int restarts_to_go = restart_interval;
    int next_rst = 0;
    for (int my = 0; my < mcus_h; ++my) {
      for (int mx = 0; mx < mcus_w; ++mx) {
        if (restart_interval) {
          if (restarts_to_go == 0) {  // jdhuff.c process_restart
            br.to_marker();
            if (br.p + 1 >= br.end || br.p[1] != 0xD0 + next_rst) {
              return kCorrupt;
            }
            br.p += 2;
            br.at_marker = false;
            next_rst = (next_rst + 1) & 7;
            restarts_to_go = restart_interval;
            for (int& v : pred) v = 0;
          }
          --restarts_to_go;
        }
        for (int i = 0; i < ns; ++i) {
          const int c = sc[i];
          const Component& cp = info.comp[c];
          const int bh = ns == 1 ? 1 : cp.v_samp;
          const int bw = ns == 1 ? 1 : cp.h_samp;
          for (int v = 0; v < bh; ++v) {
            for (int h = 0; h < bw; ++h) {
              const int by = my * bh + v, bx = mx * bw + h;
              int16_t* block =
                  by < cp.blocks_h && bx < cp.blocks_w
                      ? coefs[c] + (static_cast<size_t>(by) * cp.blocks_w +
                                    bx) * 64
                      : nullptr;  // a dummy block
              const int rc =
                  decode_block(&br, dc[td[i]], ac[ta[i]], &pred[i], block);
              if (rc != kOk) return rc;
            }
          }
        }
      }
    }
    br.to_marker();
    pos = static_cast<size_t>(br.p - data);
    return kOk;
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
        case 0xC7: case 0xC9: case 0xCA: case 0xCB: case 0xCD: case 0xCE:
        case 0xCF:
          rc = read_sof(marker);
          break;
        case 0xCC:
          rc = kArithmetic;  // DAC
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
            if (!latched[c]) return kCorrupt;  // a component never coded
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
// the geometry `info` gave) and qtables[c] (64 uint16, natural order).
int decode_coefs(const uint8_t* data, size_t size, const Info& info,
                 int16_t* const* coefs, uint16_t* const* qtables) {
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
  return kOk;
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
// (kMaxComps of them) h_samp, v_samp, width, height, blocks_w, blocks_h.
constexpr int kInfoInts = 3 + 6 * kMaxComps;

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

// n JPEG files' coefficients, on n_threads threads: coefs[i * 3 + c] points
// at frame i's component c, (blocks_h, blocks_w, 64) int16 as
// ammc_jpeg_info gave them, qtables at n * 3 * 64 uint16 (frame i's
// component c at (i * 3 + c) * 64).  Returns 0 or the first error code.
int ammc_jpeg_coefs_video(const char** paths, int n, int n_threads,
                          int16_t** coefs, uint16_t* qtables) {
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
    return ammc_jpeg::decode_coefs(data.data(), data.size(), info,
                                   coefs + static_cast<size_t>(i) * 3, qts);
  });
}

}  // extern "C"
