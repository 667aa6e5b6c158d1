/* Write a JPEG with libjpeg in a mode cv2 cannot ask for.
 *
 *   libjpeg_write <in.raw> <w> <h> <out.jpg> <mode> [gray]
 *
 * in.raw holds h * w RGB pixels (or gray ones with "gray"), quality 85.
 * Modes: "nonint" (4:2:0, one scan per component, restart interval 7),
 * "rowrst" (a restart marker at the end of every MCU row), "arith"
 * (arithmetic coding, SOF9), "arithrst" (SOF9, restart interval 5),
 * "sof10" (arithmetic progressive: jpeg_simple_progression), "sof10rst"
 * (SOF10, restart interval 3), "progrst" (Huffman progressive, restart
 * interval 4), "sa" (Huffman progressive with a deeper successive-
 * approximation script: three DC stages, split AC bands, three AC stages),
 * "sarst" ("sa", restart interval 2, so EOB runs end at restarts),
 * "partial" (Huffman progressive whose AC bands are never refined to their
 * last bit, which libjpeg's decoder smooths), "dconly" (Huffman progressive,
 * one DC scan and no AC scan: libjpeg smooths the DC too), "al1" (Huffman
 * progressive: AC 1-9 coded once with Al = 1 and never refined, AC 10-63 in
 * full), "chromadc" (Huffman progressive: luma in full, chroma DC alone),
 * "arithpartial" ("partial", arithmetic-coded: SOF10).  The last five are
 * the scripts libjpeg's decoder block-smooths (jdcoefct.c
 * decompress_smooth_data).
 *
 * Built by tests/test_torch_native.py and scripts/make_torch_jpeg_fixture.py
 * with: gcc -O2 libjpeg_write.c -o libjpeg_write -ljpeg
 */
#include <stdio.h>
#include <stdlib.h>
#include <string.h>
#include <jpeglib.h>

/* one scan: components, Ss, Se, Ah, Al */
static void scan(jpeg_scan_info* s, int ncomp, int first, int ss, int se,
                 int ah, int al) {
  s->comps_in_scan = ncomp;
  for (int i = 0; i < ncomp; i++) s->component_index[i] = first + i;
  s->Ss = ss;
  s->Se = se;
  s->Ah = ah;
  s->Al = al;
}

/* the "sa" script for `nc` components; returns the number of scans */
static int sa_script(jpeg_scan_info* s, int nc) {
  int n = 0;
  scan(&s[n++], nc, 0, 0, 0, 0, 2);           /* DC first, Al 2 */
  scan(&s[n++], 1, 0, 1, 5, 0, 3);            /* Y low band, Al 3 */
  for (int c = nc - 1; c > 0; c--) scan(&s[n++], 1, c, 1, 63, 0, 2);
  scan(&s[n++], 1, 0, 6, 63, 0, 3);           /* Y high band, Al 3 */
  scan(&s[n++], 1, 0, 1, 63, 3, 2);           /* Y refine to Al 2 */
  scan(&s[n++], nc, 0, 0, 0, 2, 1);           /* DC refine to Al 1 */
  scan(&s[n++], nc, 0, 0, 0, 1, 0);           /* DC refine to Al 0 */
  for (int c = nc - 1; c >= 0; c--) scan(&s[n++], 1, c, 1, 63, 2, 1);
  for (int c = nc - 1; c >= 0; c--) scan(&s[n++], 1, c, 1, 63, 1, 0);
  return n;
}

int main(int argc, char** argv) {
  if (argc < 6) return 2;
  const int w = atoi(argv[2]), h = atoi(argv[3]);
  const int nc = argc > 6 && !strcmp(argv[6], "gray") ? 1 : 3;
  const char* mode = argv[5];
  unsigned char* px = malloc((size_t)w * h * nc);
  FILE* f = fopen(argv[1], "rb");
  if (!f || fread(px, 1, (size_t)w * h * nc, f) != (size_t)w * h * nc) return 1;
  fclose(f);
  struct jpeg_compress_struct c;
  struct jpeg_error_mgr e;
  c.err = jpeg_std_error(&e);
  jpeg_create_compress(&c);
  FILE* o = fopen(argv[4], "wb");
  if (!o) return 1;
  jpeg_stdio_dest(&c, o);
  c.image_width = w;
  c.image_height = h;
  c.input_components = nc;
  c.in_color_space = nc == 1 ? JCS_GRAYSCALE : JCS_RGB;
  jpeg_set_defaults(&c);
  jpeg_set_quality(&c, 85, TRUE);
  static jpeg_scan_info scans[32];
  if (!strcmp(mode, "nonint")) {
    for (int i = 0; i < nc; i++) scan(&scans[i], 1, i, 0, 63, 0, 0);
    c.scan_info = scans;
    c.num_scans = nc;
    c.restart_interval = 7;
  } else if (!strcmp(mode, "rowrst")) {
    c.restart_in_rows = 1;
  } else if (!strcmp(mode, "partial") || !strcmp(mode, "arithpartial")) {
    int n = 0;
    scan(&scans[n++], nc, 0, 0, 0, 0, 0);
    for (int i = 0; i < nc; i++) scan(&scans[n++], 1, i, 1, 63, 0, 1);
    c.scan_info = scans;
    c.num_scans = n;
    c.arith_code = !strcmp(mode, "arithpartial");
  } else if (!strcmp(mode, "dconly")) {
    scan(&scans[0], nc, 0, 0, 0, 0, 0);
    c.scan_info = scans;
    c.num_scans = 1;
  } else if (!strcmp(mode, "al1")) {
    int n = 0;
    scan(&scans[n++], nc, 0, 0, 0, 0, 0);
    for (int i = 0; i < nc; i++) scan(&scans[n++], 1, i, 1, 9, 0, 1);
    for (int i = 0; i < nc; i++) scan(&scans[n++], 1, i, 10, 63, 0, 0);
    c.scan_info = scans;
    c.num_scans = n;
  } else if (!strcmp(mode, "chromadc")) {
    int n = 0;
    scan(&scans[n++], nc, 0, 0, 0, 0, 0);
    scan(&scans[n++], 1, 0, 1, 63, 0, 0);
    c.scan_info = scans;
    c.num_scans = n;
  } else if (!strncmp(mode, "arith", 5) || !strncmp(mode, "sof10", 5)) {
    c.arith_code = TRUE;
    if (!strncmp(mode, "sof10", 5)) jpeg_simple_progression(&c);
    if (!strcmp(mode, "arithrst")) c.restart_interval = 5;
    if (!strcmp(mode, "sof10rst")) c.restart_interval = 3;
  } else if (!strcmp(mode, "progrst")) {
    jpeg_simple_progression(&c);
    c.restart_interval = 4;
  } else if (!strncmp(mode, "sa", 2)) {
    c.scan_info = scans;
    c.num_scans = sa_script(scans, nc);
    if (!strcmp(mode, "sarst")) c.restart_interval = 2;
  } else {
    return 2;
  }
  jpeg_start_compress(&c, TRUE);
  while (c.next_scanline < c.image_height) {
    JSAMPROW row = px + (size_t)c.next_scanline * w * nc;
    jpeg_write_scanlines(&c, &row, 1);
  }
  jpeg_finish_compress(&c);
  fclose(o);
  free(px);
  return 0;
}
