// CPython extension: binary max-heap with vector-valued priorities and
// score lookup/update by item.
//
// Operation-for-operation mirror of whatshap_torch/priorityqueue.py (which
// has parity with the reference's whatshap/priorityqueue.pyx): the heap's
// unstable tie behavior is part of the read-selection output contract, so
// sift_up/sift_down/swap follow the exact same comparison and swap order —
// the heap layout after any operation sequence is identical to the Python
// implementation's.  Scores are int64 vectors (the reference's Cython
// vector<int> has the same boundedness).

#define PY_SSIZE_T_CLEAN
#include <Python.h>

#include <cstdint>
#include <unordered_map>
#include <vector>

namespace {

struct Entry {
    std::vector<int64_t> score;
    int64_t item;
};

struct PQObject {
    PyObject_HEAD
    std::vector<Entry>* heap;
    std::unordered_map<int64_t, Py_ssize_t>* positions;
};

bool vector_score_lower(const std::vector<int64_t>& a, const std::vector<int64_t>& b) {
    size_t n = a.size() < b.size() ? a.size() : b.size();
    for (size_t i = 0; i < n; i++) {
        if (a[i] < b[i]) return true;
        if (a[i] > b[i]) return false;
    }
    return a.size() < b.size();
}

void pq_swap(PQObject* self, Py_ssize_t i1, Py_ssize_t i2) {
    auto& heap = *self->heap;
    auto& pos = *self->positions;
    Py_ssize_t p1 = pos[heap[i1].item];
    Py_ssize_t p2 = pos[heap[i2].item];
    pos[heap[i1].item] = p2;
    pos[heap[i2].item] = p1;
    std::swap(heap[i1], heap[i2]);
}

bool score_lower(PQObject* self, Py_ssize_t i1, Py_ssize_t i2) {
    return vector_score_lower((*self->heap)[i1].score, (*self->heap)[i2].score);
}

void sift_up(PQObject* self, Py_ssize_t index) {
    while (index > 0) {
        Py_ssize_t parent = (index - 1) / 2;
        if (score_lower(self, parent, index)) {
            pq_swap(self, parent, index);
            index = parent;
        } else {
            break;
        }
    }
}

void sift_down(PQObject* self, Py_ssize_t index) {
    Py_ssize_t n = (Py_ssize_t)self->heap->size();
    for (;;) {
        Py_ssize_t l = 2 * index + 1, r = 2 * index + 2;
        if (r < n) {
            if (score_lower(self, l, r)) {
                if (score_lower(self, index, r)) {
                    pq_swap(self, r, index);
                    index = r;
                    continue;
                }
            } else {
                if (score_lower(self, index, l)) {
                    pq_swap(self, l, index);
                    index = l;
                    continue;
                }
            }
        } else if (l < n) {
            if (score_lower(self, index, l)) {
                pq_swap(self, l, index);
                index = l;
                continue;
            }
        }
        break;
    }
}

int score_from_obj(PyObject* obj, std::vector<int64_t>& out) {
    // obj must be a tuple of ints (the Python wrapper normalizes)
    if (!PyTuple_Check(obj)) {
        PyErr_SetString(PyExc_TypeError, "score must be a tuple of ints");
        return -1;
    }
    Py_ssize_t n = PyTuple_GET_SIZE(obj);
    out.resize((size_t)n);
    for (Py_ssize_t i = 0; i < n; i++) {
        int64_t v = PyLong_AsLongLong(PyTuple_GET_ITEM(obj, i));
        if (v == -1 && PyErr_Occurred()) return -1;
        out[(size_t)i] = v;
    }
    return 0;
}

PyObject* score_to_tuple(const std::vector<int64_t>& score) {
    PyObject* t = PyTuple_New((Py_ssize_t)score.size());
    if (!t) return nullptr;
    for (size_t i = 0; i < score.size(); i++)
        PyTuple_SET_ITEM(t, (Py_ssize_t)i, PyLong_FromLongLong(score[i]));
    return t;
}

// --- methods ---------------------------------------------------------------

PyObject* PQ_push(PQObject* self, PyObject* args) {
    PyObject* score_obj;
    long long item;
    if (!PyArg_ParseTuple(args, "OL", &score_obj, &item)) return nullptr;
    Entry e;
    if (score_from_obj(score_obj, e.score) < 0) return nullptr;
    e.item = item;
    Py_ssize_t newindex = (Py_ssize_t)self->heap->size();
    self->heap->push_back(std::move(e));
    (*self->positions)[item] = newindex;
    sift_up(self, newindex);
    Py_RETURN_NONE;
}

PyObject* PQ_pop(PQObject* self, PyObject*) {
    auto& heap = *self->heap;
    auto& pos = *self->positions;
    if (heap.empty()) {
        PyErr_SetString(PyExc_IndexError, "PriorityQueue empty.");
        return nullptr;
    }
    Entry first = heap[0];
    if (heap.size() == 1) {
        pos.erase(first.item);
        heap.pop_back();
    } else {
        Entry last = heap.back();
        heap.pop_back();
        heap[0] = last;
        pos[last.item] = 0;
        pos.erase(first.item);
        sift_down(self, 0);
    }
    PyObject* st = score_to_tuple(first.score);
    if (!st) return nullptr;
    PyObject* res = Py_BuildValue("(NL)", st, (long long)first.item);
    return res;
}

PyObject* PQ_change_score(PQObject* self, PyObject* args) {
    long long item;
    PyObject* score_obj;
    if (!PyArg_ParseTuple(args, "LO", &item, &score_obj)) return nullptr;
    auto it = self->positions->find(item);
    if (it == self->positions->end()) {
        PyErr_SetString(PyExc_KeyError, "item not in queue");
        return nullptr;
    }
    Py_ssize_t position = it->second;
    std::vector<int64_t> new_score;
    if (score_from_obj(score_obj, new_score) < 0) return nullptr;
    std::vector<int64_t> old_score = (*self->heap)[position].score;
    (*self->heap)[position].score = std::move(new_score);
    if (vector_score_lower(old_score, (*self->heap)[position].score))
        sift_up(self, position);
    else
        sift_down(self, position);
    Py_RETURN_NONE;
}

PyObject* PQ_get_score_by_item(PQObject* self, PyObject* args) {
    long long item;
    if (!PyArg_ParseTuple(args, "L", &item)) return nullptr;
    auto it = self->positions->find(item);
    if (it == self->positions->end()) Py_RETURN_NONE;
    return score_to_tuple((*self->heap)[it->second].score);
}

PyObject* PQ_is_empty(PQObject* self, PyObject*) {
    return PyBool_FromLong(self->heap->empty() ? 1 : 0);
}

Py_ssize_t PQ_len(PyObject* self) {
    return (Py_ssize_t)((PQObject*)self)->heap->size();
}

PyObject* PQ_new(PyTypeObject* type, PyObject*, PyObject*) {
    PQObject* self = (PQObject*)type->tp_alloc(type, 0);
    if (self) {
        self->heap = new std::vector<Entry>();
        self->positions = new std::unordered_map<int64_t, Py_ssize_t>();
    }
    return (PyObject*)self;
}

void PQ_dealloc(PQObject* self) {
    delete self->heap;
    delete self->positions;
    Py_TYPE(self)->tp_free((PyObject*)self);
}

PyMethodDef PQ_methods[] = {
    {"c_push", (PyCFunction)PQ_push, METH_VARARGS, "push(score_tuple, item)"},
    {"c_pop", (PyCFunction)PQ_pop, METH_NOARGS, "pop() -> (score_tuple, item)"},
    {"c_change_score", (PyCFunction)PQ_change_score, METH_VARARGS, "change_score(item, score_tuple)"},
    {"c_get_score_by_item", (PyCFunction)PQ_get_score_by_item, METH_VARARGS,
     "get_score_by_item(item) -> score_tuple | None"},
    {"c_is_empty", (PyCFunction)PQ_is_empty, METH_NOARGS, "is_empty() -> bool"},
    {nullptr, nullptr, 0, nullptr},
};

PySequenceMethods PQ_as_sequence = {
    PQ_len,  // sq_length
};

PyTypeObject PQType = {
    PyVarObject_HEAD_INIT(nullptr, 0)
    "_pqext.PriorityQueueExt",    // tp_name
    sizeof(PQObject),             // tp_basicsize
};

PyModuleDef pqmodule = {
    PyModuleDef_HEAD_INIT,
    "_pqext",
    "Native binary max-heap with vector priorities (readselect hot path)",
    -1,
    nullptr,
};

}  // namespace

PyMODINIT_FUNC PyInit__pqext(void) {
    PQType.tp_dealloc = (destructor)PQ_dealloc;
    PQType.tp_flags = Py_TPFLAGS_DEFAULT;
    PQType.tp_methods = PQ_methods;
    PQType.tp_new = PQ_new;
    PQType.tp_as_sequence = &PQ_as_sequence;
    if (PyType_Ready(&PQType) < 0) return nullptr;
    PyObject* m = PyModule_Create(&pqmodule);
    if (!m) return nullptr;
    Py_INCREF(&PQType);
    if (PyModule_AddObject(m, "PriorityQueueExt", (PyObject*)&PQType) < 0) {
        Py_DECREF(&PQType);
        Py_DECREF(m);
        return nullptr;
    }
    return m;
}
