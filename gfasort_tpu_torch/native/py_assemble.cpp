// CPython-API graph-assembly helpers.
//
// The C++ GFA parser (gfa_parser.cpp) produces struct-of-arrays buffers;
// turning those into the BidirectedGraph's Python containers (a list of
// per-node `bytes`, the GFA-insertion-order list, and the deduped edge
// set — gfasort src/graph_ops.rs:10-16) used to be the load-time
// bottleneck (~4 s of Python loops for a 1M-node graph).  These helpers
// build the containers directly with the CPython API.
//
// They are called through ctypes.PyDLL (GIL held) — never through the
// CDLL handle, which releases the GIL around calls.

#define PY_SSIZE_T_CLEAN
#include <Python.h>

#include <cstdint>
#include <string>

extern "C" {

// Returns (nodes, node_order):
//   nodes      — list sized max_id+1, bytes at each live id, None elsewhere
//   node_order — list of ids in first-seen file order
// Duplicate S-lines overwrite the sequence but keep the original order slot
// (same as BidirectedGraph.add_node / src/graph_ops.rs:613-623).
PyObject* gfa_build_nodes(int64_t n_segs, const int64_t* ids,
                          const int64_t* off, const char* blob) {
    int64_t max_id = -1;
    for (int64_t i = 0; i < n_segs; i++)
        if (ids[i] > max_id) max_id = ids[i];

    PyObject* nodes = PyList_New(max_id + 1);
    if (!nodes) return NULL;
    for (int64_t i = 0; i <= max_id; i++) {
        Py_INCREF(Py_None);
        PyList_SET_ITEM(nodes, i, Py_None);
    }
    PyObject* order = PyList_New(0);
    if (!order) {
        Py_DECREF(nodes);
        return NULL;
    }
    for (int64_t i = 0; i < n_segs; i++) {
        int64_t nid = ids[i];
        if (PyList_GET_ITEM(nodes, nid) == Py_None) {
            PyObject* idobj = PyLong_FromLongLong(nid);
            if (!idobj || PyList_Append(order, idobj) < 0) {
                Py_XDECREF(idobj);
                goto fail;
            }
            Py_DECREF(idobj);
        }
        PyObject* seq = PyBytes_FromStringAndSize(blob + off[i], off[i + 1] - off[i]);
        if (!seq) goto fail;
        PyList_SetItem(nodes, nid, seq);  // steals ref, releases the old item
    }
    {
        PyObject* out = PyTuple_Pack(2, nodes, order);
        Py_DECREF(nodes);
        Py_DECREF(order);
        return out;
    }
fail:
    Py_DECREF(nodes);
    Py_DECREF(order);
    return NULL;
}

// Returns a set of (from_handle, to_handle) tuples.  The parser already
// deduped edge/complement forms (src/graph_ops.rs:626-638), so this is a
// plain container build.
PyObject* gfa_build_edges(int64_t n, const int64_t* from, const int64_t* to) {
    PyObject* s = PySet_New(NULL);
    if (!s) return NULL;
    for (int64_t i = 0; i < n; i++) {
        PyObject* t = PyTuple_New(2);
        if (!t) goto fail;
        PyObject* a = PyLong_FromLongLong(from[i]);
        PyObject* b = PyLong_FromLongLong(to[i]);
        if (!a || !b) {
            Py_XDECREF(a);
            Py_XDECREF(b);
            Py_DECREF(t);
            goto fail;
        }
        PyTuple_SET_ITEM(t, 0, a);
        PyTuple_SET_ITEM(t, 1, b);
        if (PySet_Add(s, t) < 0) {
            Py_DECREF(t);
            goto fail;
        }
        Py_DECREF(t);
    }
    return s;
fail:
    Py_DECREF(s);
    return NULL;
}

// Rewrite an edge set {(from_handle, to_handle)} through a node-id LUT
// (BidirectedGraph._remap_arrays hot path).  lut[id] is the new id, or
// -1 for "not in the mapping"; ids >= lut_len are treated as unmapped.
// drop_unmapped=0 → unmapped ids pass through (apply_node_id_mapping,
// src/graph_ops.rs:52-83); drop_unmapped=1 → edges touching an unmapped
// id are dropped (apply_ordering, src/graph_ops.rs:1983-2020).
PyObject* remap_edge_set(PyObject* edges, const int64_t* lut, int64_t lut_len,
                         int drop_unmapped) {
    PyObject* out = PySet_New(NULL);
    if (!out) return NULL;
    PyObject* it = PyObject_GetIter(edges);
    if (!it) {
        Py_DECREF(out);
        return NULL;
    }
    PyObject* item;
    while ((item = PyIter_Next(it)) != NULL) {
        int64_t h[2];
        int ok = 1, drop = 0;
        for (int k = 0; k < 2; k++) {
            PyObject* v = PyTuple_GetItem(item, k);  // borrowed
            if (!v) { ok = 0; break; }
            int64_t hv = PyLong_AsLongLong(v);
            if (hv == -1 && PyErr_Occurred()) { ok = 0; break; }
            int64_t nid = hv >> 1;
            int64_t mapped = (nid >= 0 && nid < lut_len) ? lut[nid] : -1;
            if (mapped < 0) {
                if (drop_unmapped) { drop = 1; break; }
                mapped = nid;
            }
            h[k] = (mapped << 1) | (hv & 1);
        }
        Py_DECREF(item);
        if (!ok) goto fail;
        if (drop) continue;
        {
            PyObject* t = PyTuple_New(2);
            if (!t) goto fail;
            PyObject* a = PyLong_FromLongLong(h[0]);
            PyObject* b = PyLong_FromLongLong(h[1]);
            if (!a || !b) {
                Py_XDECREF(a);
                Py_XDECREF(b);
                Py_DECREF(t);
                goto fail;
            }
            PyTuple_SET_ITEM(t, 0, a);
            PyTuple_SET_ITEM(t, 1, b);
            if (PySet_Add(out, t) < 0) {
                Py_DECREF(t);
                goto fail;
            }
            Py_DECREF(t);
        }
    }
    Py_DECREF(it);
    if (PyErr_Occurred()) {
        Py_DECREF(out);
        return NULL;
    }
    return out;
fail:
    Py_DECREF(it);
    Py_DECREF(out);
    return NULL;
}

// Fill out[i] = sequence length of node i, or -1 where the slot is None
// (dead / never present).  Returns the live-node count, or -1 on error.
// One pass replaces the Python `enumerate(graph.nodes)` loops that
// dominate PathIndex construction at chromosome scale.
int64_t node_len_fill(PyObject* nodes, int64_t* out) {
    if (!PyList_Check(nodes)) {
        PyErr_SetString(PyExc_TypeError, "nodes must be a list");
        return -1;
    }
    Py_ssize_t n = PyList_GET_SIZE(nodes);
    int64_t live = 0;
    for (Py_ssize_t i = 0; i < n; i++) {
        PyObject* v = PyList_GET_ITEM(nodes, i);
        if (v == Py_None) {
            out[i] = -1;
        } else if (PyBytes_Check(v)) {
            out[i] = PyBytes_GET_SIZE(v);
            live++;
        } else {
            Py_ssize_t len = PyObject_Length(v);
            if (len < 0) return -1;
            out[i] = len;
            live++;
        }
    }
    return live;
}

// Dump the edge set {(from_handle, to_handle)} into two int64 arrays.
// Returns the edge count or -1 on error.
int64_t edge_set_to_arrays(PyObject* edges, int64_t* ef, int64_t* et) {
    PyObject* it = PyObject_GetIter(edges);
    if (!it) return -1;
    int64_t n = 0;
    PyObject* item;
    while ((item = PyIter_Next(it)) != NULL) {
        PyObject* a = PyTuple_GetItem(item, 0);
        PyObject* b = PyTuple_GetItem(item, 1);
        if (!a || !b) {
            Py_DECREF(item);
            Py_DECREF(it);
            return -1;
        }
        ef[n] = PyLong_AsLongLong(a);
        et[n] = PyLong_AsLongLong(b);
        n++;
        Py_DECREF(item);
    }
    Py_DECREF(it);
    if (PyErr_Occurred()) return -1;
    return n;
}

// New edge set with handle orientations XOR'd where flip[node_id] is
// nonzero (apply_grooming_with_reorder hot path, src/groom.rs:559-575).
PyObject* flip_edge_set(PyObject* edges, const uint8_t* flip, int64_t flip_len) {
    PyObject* out = PySet_New(NULL);
    if (!out) return NULL;
    PyObject* it = PyObject_GetIter(edges);
    if (!it) {
        Py_DECREF(out);
        return NULL;
    }
    PyObject* item;
    while ((item = PyIter_Next(it)) != NULL) {
        int64_t h[2];
        int ok = 1;
        for (int k = 0; k < 2; k++) {
            PyObject* v = PyTuple_GetItem(item, k);
            if (!v) { ok = 0; break; }
            int64_t hv = PyLong_AsLongLong(v);
            if (hv == -1 && PyErr_Occurred()) { ok = 0; break; }
            int64_t nid = hv >> 1;
            if (nid >= 0 && nid < flip_len && flip[nid]) hv ^= 1;
            h[k] = hv;
        }
        Py_DECREF(item);
        if (!ok) goto flip_fail;
        {
            PyObject* t = PyTuple_New(2);
            if (!t) goto flip_fail;
            PyObject* a = PyLong_FromLongLong(h[0]);
            PyObject* b = PyLong_FromLongLong(h[1]);
            if (!a || !b) {
                Py_XDECREF(a);
                Py_XDECREF(b);
                Py_DECREF(t);
                goto flip_fail;
            }
            PyTuple_SET_ITEM(t, 0, a);
            PyTuple_SET_ITEM(t, 1, b);
            if (PySet_Add(out, t) < 0) {
                Py_DECREF(t);
                goto flip_fail;
            }
            Py_DECREF(t);
        }
    }
    Py_DECREF(it);
    if (PyErr_Occurred()) {
        Py_DECREF(out);
        return NULL;
    }
    return out;
flip_fail:
    Py_DECREF(it);
    Py_DECREF(out);
    return NULL;
}

namespace {
// A/T/C/G case-insensitive -> complement uppercase, N/n -> N, everything
// else passes through (reference: src/graph.rs:72-85; must match
// handle._RC_TABLE).
struct RcTable {
    unsigned char t[256];
    RcTable() {
        for (int i = 0; i < 256; i++) t[i] = (unsigned char)i;
        t['A'] = 'T'; t['a'] = 'T';
        t['T'] = 'A'; t['t'] = 'A';
        t['C'] = 'G'; t['c'] = 'G';
        t['G'] = 'C'; t['g'] = 'C';
        t['N'] = 'N'; t['n'] = 'N';
    }
};
const RcTable kRc;
}  // namespace

// Replace nodes[ids[i]] with its reverse complement, in place, for all
// given ids.  Returns 0 or -1 on error.
int64_t rc_nodes_inplace(PyObject* nodes, const int64_t* ids, int64_t n) {
    if (!PyList_Check(nodes)) {
        PyErr_SetString(PyExc_TypeError, "nodes must be a list");
        return -1;
    }
    Py_ssize_t list_n = PyList_GET_SIZE(nodes);
    for (int64_t i = 0; i < n; i++) {
        int64_t nid = ids[i];
        if (nid < 0 || nid >= list_n) continue;
        PyObject* v = PyList_GET_ITEM(nodes, nid);
        if (v == Py_None || !PyBytes_Check(v)) continue;
        Py_ssize_t len = PyBytes_GET_SIZE(v);
        PyObject* out = PyBytes_FromStringAndSize(NULL, len);
        if (!out) return -1;
        const unsigned char* src = (const unsigned char*)PyBytes_AS_STRING(v);
        unsigned char* dst = (unsigned char*)PyBytes_AS_STRING(out);
        for (Py_ssize_t k = 0; k < len; k++)
            dst[k] = kRc.t[src[len - 1 - k]];
        PyList_SetItem(nodes, nid, out);  // steals ref, drops old
    }
    return 0;
}

namespace {
// append a decimal int64 to a byte buffer
inline void append_int(std::string& buf, int64_t v) {
    char tmp[24];
    int n = 0;
    if (v < 0) { buf.push_back('-'); v = -v; }
    do {
        tmp[n++] = (char)('0' + v % 10);
        v /= 10;
    } while (v);
    while (n) buf.push_back(tmp[--n]);
}
}  // namespace

// "S\t<id>\t<seq>\n" for every live node, as one bytes object.
PyObject* format_s_lines(PyObject* nodes) {
    if (!PyList_Check(nodes)) {
        PyErr_SetString(PyExc_TypeError, "nodes must be a list");
        return NULL;
    }
    Py_ssize_t n = PyList_GET_SIZE(nodes);
    std::string buf;
    buf.reserve(64);
    for (Py_ssize_t i = 0; i < n; i++) {
        PyObject* v = PyList_GET_ITEM(nodes, i);
        if (v == Py_None) continue;
        if (!PyBytes_Check(v)) {
            PyErr_SetString(PyExc_TypeError, "node sequences must be bytes");
            return NULL;
        }
        buf += "S\t";
        append_int(buf, (int64_t)i);
        buf.push_back('\t');
        buf.append(PyBytes_AS_STRING(v), PyBytes_GET_SIZE(v));
        buf.push_back('\n');
    }
    return PyBytes_FromStringAndSize(buf.data(), (Py_ssize_t)buf.size());
}

// "L\t<fid>\t<+/->\t<tid>\t<+/->\t0M\n" per edge (with_overlap=1 appends
// the 0M column), as one bytes object.  Caller passes edges pre-sorted.
PyObject* format_l_lines(int64_t n, const int64_t* ef, const int64_t* et,
                         int with_overlap) {
    std::string buf;
    buf.reserve((size_t)n * 16);
    for (int64_t i = 0; i < n; i++) {
        buf += "L\t";
        append_int(buf, ef[i] >> 1);
        buf.push_back('\t');
        buf.push_back((ef[i] & 1) ? '-' : '+');
        buf.push_back('\t');
        append_int(buf, et[i] >> 1);
        buf.push_back('\t');
        buf.push_back((et[i] & 1) ? '-' : '+');
        if (with_overlap) buf += "\t0M";
        buf.push_back('\n');
    }
    return PyBytes_FromStringAndSize(buf.data(), (Py_ssize_t)buf.size());
}

// "<id><+/->,<id><+/->,..." for a path's step handles, as bytes.
PyObject* format_steps(int64_t n, const int64_t* steps) {
    std::string buf;
    buf.reserve((size_t)n * 8);
    for (int64_t i = 0; i < n; i++) {
        if (i) buf.push_back(',');
        append_int(buf, steps[i] >> 1);
        buf.push_back((steps[i] & 1) ? '-' : '+');
    }
    return PyBytes_FromStringAndSize(buf.data(), (Py_ssize_t)buf.size());
}

}  // extern "C"
