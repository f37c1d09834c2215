/* Native PNG writer — the TPU framework's analog of the reference's
 * vendored stb_image_write.h (HW1/src/render.cpp:119-125,
 * GPUandCPU/src/main.cu:426-433 write render output through native C).
 *
 * Self-contained like stb: no zlib dependency.  IDAT uses zlib STORED
 * deflate blocks (raw bytes, no compression) + adler32, which every
 * PNG reader accepts; CRC32 is the standard table-driven form.  The
 * Python caller does the float->uint8 quantization (dialect-specific),
 * so decoded pixels are byte-identical to the Pillow path.
 *
 * Exported:
 *   int fi_write_png_rgb8(const char *path, int w, int h,
 *                         const unsigned char *rgb);   // 0 on success
 */
#include <stdint.h>
#include <stdio.h>
#include <stdlib.h>
#include <string.h>

static uint32_t crc_table[256];
static int crc_ready = 0;

static void crc_init(void) {
    for (uint32_t n = 0; n < 256; n++) {
        uint32_t c = n;
        for (int k = 0; k < 8; k++)
            c = (c & 1) ? 0xEDB88320u ^ (c >> 1) : (c >> 1);
        crc_table[n] = c;
    }
    crc_ready = 1;
}

static uint32_t crc_update(uint32_t crc, const unsigned char *buf,
                           size_t len) {
    for (size_t i = 0; i < len; i++)
        crc = crc_table[(crc ^ buf[i]) & 0xFF] ^ (crc >> 8);
    return crc;
}

static uint32_t adler32(const unsigned char *buf, size_t len) {
    uint32_t a1 = 1, a2 = 0;
    for (size_t i = 0; i < len; i++) {
        a1 += buf[i];
        if (a1 >= 65521) a1 -= 65521;
        a2 += a1;
        if (a2 >= 65521) a2 -= 65521;
    }
    return (a2 << 16) | a1;
}

static void put_be32(unsigned char *p, uint32_t v) {
    p[0] = (unsigned char)(v >> 24);
    p[1] = (unsigned char)(v >> 16);
    p[2] = (unsigned char)(v >> 8);
    p[3] = (unsigned char)v;
}

/* write one chunk: length, type, data, crc(type+data) */
static int write_chunk(FILE *f, const char type[4],
                       const unsigned char *data, uint32_t len) {
    unsigned char hdr[8], crcb[4];
    put_be32(hdr, len);
    memcpy(hdr + 4, type, 4);
    if (fwrite(hdr, 1, 8, f) != 8) return -1;
    if (len && fwrite(data, 1, len, f) != len) return -1;
    uint32_t crc = crc_update(0xFFFFFFFFu, (const unsigned char *)type, 4);
    if (len) crc = crc_update(crc, data, len);
    put_be32(crcb, crc ^ 0xFFFFFFFFu);
    return fwrite(crcb, 1, 4, f) == 4 ? 0 : -1;
}

int fi_write_png_rgb8(const char *path, int w, int h,
                      const unsigned char *rgb) {
    if (w <= 0 || h <= 0 || !rgb) return -2;
    if (!crc_ready) crc_init();

    /* raw PNG stream: per scanline, filter byte 0 + RGB bytes */
    size_t stride = (size_t)w * 3;
    size_t raw_len = (size_t)h * (stride + 1);
    unsigned char *raw = (unsigned char *)malloc(raw_len);
    if (!raw) return -4;
    for (int y = 0; y < h; y++) {
        unsigned char *dst = raw + (size_t)y * (stride + 1);
        dst[0] = 0; /* filter: none */
        memcpy(dst + 1, rgb + (size_t)y * stride, stride);
    }

    /* zlib wrapper: 2-byte header, STORED blocks (<=65535 each),
       4-byte adler32 over the raw stream */
    size_t nblocks = (raw_len + 65534) / 65535;
    size_t idat_len = 2 + raw_len + nblocks * 5 + 4;

    FILE *f = fopen(path, "wb");
    if (!f) { free(raw); return -3; }

    static const unsigned char sig[8] =
        {137, 'P', 'N', 'G', '\r', '\n', 26, '\n'};
    int rc = fwrite(sig, 1, 8, f) == 8 ? 0 : -1;

    unsigned char ihdr[13];
    put_be32(ihdr, (uint32_t)w);
    put_be32(ihdr + 4, (uint32_t)h);
    ihdr[8] = 8;   /* bit depth */
    ihdr[9] = 2;   /* color type: truecolor RGB */
    ihdr[10] = 0;  /* compression: deflate */
    ihdr[11] = 0;  /* filter method */
    ihdr[12] = 0;  /* no interlace */
    if (!rc) rc = write_chunk(f, "IHDR", ihdr, 13);

    /* stream IDAT as one chunk, computing its crc incrementally */
    unsigned char hdr[8];
    put_be32(hdr, (uint32_t)idat_len);
    memcpy(hdr + 4, "IDAT", 4);
    if (!rc) rc = fwrite(hdr, 1, 8, f) == 8 ? 0 : -1;
    uint32_t crc = crc_update(0xFFFFFFFFu, (const unsigned char *)"IDAT", 4);

#define PUT(buf, n) do { \
        if (!rc && fwrite((buf), 1, (n), f) != (size_t)(n)) rc = -1; \
        if (!rc) crc = crc_update(crc, (buf), (n)); \
    } while (0)

    unsigned char zhdr[2] = {0x78, 0x01}; /* 32K window, fastest */
    PUT(zhdr, 2);
    size_t off = 0;
    while (off < raw_len && !rc) {
        size_t remain = raw_len - off;
        size_t blk = remain > 65535 ? 65535 : remain;
        unsigned char bh[5];
        bh[0] = (remain == blk) ? 1 : 0; /* BFINAL on the last block */
        bh[1] = (unsigned char)(blk & 0xFF);
        bh[2] = (unsigned char)(blk >> 8);
        bh[3] = (unsigned char)~bh[1];
        bh[4] = (unsigned char)~bh[2];
        PUT(bh, 5);
        PUT(raw + off, blk);
        off += blk;
    }
    unsigned char adl[4];
    put_be32(adl, adler32(raw, raw_len));
    PUT(adl, 4);
#undef PUT
    unsigned char crcb[4];
    put_be32(crcb, crc ^ 0xFFFFFFFFu);
    if (!rc) rc = fwrite(crcb, 1, 4, f) == 4 ? 0 : -1;

    if (!rc) rc = write_chunk(f, "IEND", NULL, 0);
    if (fclose(f) != 0) rc = -1;
    free(raw);
    return rc;
}
