// Host commit engine: the CPython-object half of the port's native host
// runtime (the array half lives in hostsched.cpp). The counterpart of
// kubernetes_tpu/native/hostcommit.cpp, written against the PORT's objects.
//
// The host commit path is interpreter work: bind/event commit, the assume
// structural loop, and build_pod_batch's fused row loop are long chains of
// tiny object operations (dict copies, instance allocation, dict inserts,
// list appends) whose cost is bytecode dispatch, not the operations
// themselves. This engine replays EXACTLY the same object operations through
// the C API, entered ONCE per batch/chunk, so the per-pod cost drops to the
// C-level primitives alone.
//
// Contract (tests/test_torch_native.py):
//   - Byte-identical results with the port's Python loops in
//     kubernetes_tpu_torch/store/store.py (pod_bind_clone,
//     pod_structural_clone, _make_event, bind_many, delete_pods),
//     store/columnar.py (PodColumns.bind_prepare), scheduler/cache.py
//     (assume_pods_structural) and snapshot/tensorizer.py (build_pod_batch):
//     same stored rows, same RV sequence, same Event instances field for
//     field (including the lazy slot layout), same placements. The Python
//     loops stay in the tree as the oracle (native_commit=False /
//     STORE_NATIVE_COMMIT=0 / HOSTSCHED_NATIVE_COMMIT=0 select them).
//   - The port's ObjectMeta has no owner_references or finalizers, so the
//     structural clone copies labels, annotations and status.conditions
//     only, exactly as pod_structural_clone does.
//   - Every entry point manipulates Python objects and therefore MUST be
//     called with the GIL HELD: the loader uses ctypes.PyDLL, which does not
//     release the GIL around calls. The GIL-RELEASING kernels (ctypes CDLL:
//     greedy_assign, commit_deltas) live in hostsched.cpp and must never be
//     called under a store lock (store/store.py, the NATIVE LOCK RULE).
//   - Errors: every path either completes or returns NULL with a Python
//     exception set (ctypes raises it); no partial hidden state beyond what
//     the equivalent Python loop would have committed before raising.

#include <Python.h>

namespace {

// interned key strings (hc_init)
PyObject* s_metadata;
PyObject* s_spec;
PyObject* s_status;
PyObject* s_node_name;
PyObject* s_resource_version;
PyObject* s_labels;
PyObject* s_annotations;
PyObject* s_conditions;
PyObject* s_type;
PyObject* s_kind;
PyObject* s_obj;
PyObject* s_prev;
PyObject* s_lazy;
PyObject* s_commit_ts;
PyObject* s_key;
PyObject* s_key_cache;
PyObject* s_req_cache;
PyObject* s_class_sig;
PyObject* s_req_sig;
PyObject* s_pods;
PyObject* s_pods_with_affinity;
PyObject* s_pods_with_req_anti;
PyObject* s_affinity;
PyObject* s_pod_aff_req;
PyObject* s_pod_anti_req;
PyObject* s_pod_aff_pref;
PyObject* s_pod_anti_pref;
PyObject* s_slot_pod;
PyObject* s_slot_request;
PyObject* s_slot_nz_request;
PyObject* s_slot_req_aff;
PyObject* s_slot_req_anti;
PyObject* s_slot_pref_aff;
PyObject* s_slot_pref_anti;
PyObject* s_kind_pods;

PyObject* g_event_type;     // store.store.Event
PyObject* g_podinfo_type;   // scheduler.framework.PodInfo
PyObject* g_nodeinfo_type;  // scheduler.framework.NodeInfo
PyObject* g_empty_tuple;
PyObject* g_zero_float;

bool g_ready = false;

inline PyObject** inst_dict_ptr(PyObject* obj) {
  return _PyObject_GetDictPtr(obj);
}

// Borrowed-ref instance-dict lookup with full-attribute fallback. On a dict
// hit returns the borrowed value (*own stays NULL); on fallback stores the
// new ref in *own and returns it (caller XDECREFs *own). NULL = error set.
PyObject* fast_attr(PyObject* obj, PyObject* name, PyObject** own) {
  *own = nullptr;
  PyObject** dp = inst_dict_ptr(obj);
  if (dp != nullptr && *dp != nullptr) {
    PyObject* v = PyDict_GetItemWithError(*dp, name);
    if (v != nullptr) return v;
    if (PyErr_Occurred()) return nullptr;
  }
  *own = PyObject_GetAttr(obj, name);
  return *own;
}

// _shallow's exact C equivalent: fresh instance of the same class whose
// __dict__ is a C-level copy of the source's. Only valid for plain classes
// with an instance dict (Pod/ObjectMeta/PodSpec/PodStatus/Event here).
PyObject* shallow_copy(PyObject* obj) {
  PyObject** sdp = inst_dict_ptr(obj);
  if (sdp == nullptr || *sdp == nullptr) {
    PyErr_SetString(PyExc_TypeError,
                    "hostcommit: shallow_copy needs an instance __dict__");
    return nullptr;
  }
  PyObject* d = PyDict_Copy(*sdp);
  if (d == nullptr) return nullptr;
  PyTypeObject* tp = Py_TYPE(obj);
  PyObject* neu = tp->tp_alloc(tp, 0);
  if (neu == nullptr) {
    Py_DECREF(d);
    return nullptr;
  }
  PyObject** ddp = inst_dict_ptr(neu);
  if (ddp == nullptr) {
    Py_DECREF(d);
    Py_DECREF(neu);
    PyErr_SetString(PyExc_TypeError,
                    "hostcommit: target class has no __dict__ slot");
    return nullptr;
  }
  // the slot is NULL after tp_alloc on 3.10; newer CPythons
  // (Py_TPFLAGS_MANAGED_DICT) may have materialized an empty dict when we
  // took the pointer — release it or every clone leaks one dict there
  Py_XSETREF(*ddp, d);
  return neu;
}

// Replace key in obj's (already private) __dict__ with a shallow copy of its
// current value; returns the borrowed new copy (owned by the dict) or NULL.
PyObject* privatize_member(PyObject* owner_dict, PyObject* key) {
  PyObject* cur = PyDict_GetItemWithError(owner_dict, key);
  if (cur == nullptr) {
    if (!PyErr_Occurred())
      PyErr_Format(PyExc_AttributeError, "hostcommit: missing %U", key);
    return nullptr;
  }
  PyObject* cp = shallow_copy(cur);
  if (cp == nullptr) return nullptr;
  if (PyDict_SetItem(owner_dict, key, cp) < 0) {
    Py_DECREF(cp);
    return nullptr;
  }
  Py_DECREF(cp);  // dict holds it
  return PyDict_GetItemWithError(owner_dict, key);
}

// store.store.pod_bind_clone, exactly: fresh Pod/ObjectMeta/PodSpec shells,
// everything else shared.
PyObject* bind_clone(PyObject* pod) {
  PyObject* neu = shallow_copy(pod);
  if (neu == nullptr) return nullptr;
  PyObject* nd = *inst_dict_ptr(neu);
  if (privatize_member(nd, s_metadata) == nullptr ||
      privatize_member(nd, s_spec) == nullptr) {
    Py_DECREF(neu);
    return nullptr;
  }
  return neu;
}

// list(x) equivalent (fresh list from any sequence/iterable)
PyObject* list_copy(PyObject* seq) { return PySequence_List(seq); }

// store.store.pod_structural_clone, exactly: private metadata (with own
// labels/annotations), private spec, private status (own conditions list).
PyObject* structural_clone(PyObject* pod) {
  PyObject* neu = shallow_copy(pod);
  if (neu == nullptr) return nullptr;
  PyObject* nd = *inst_dict_ptr(neu);
  PyObject* meta = privatize_member(nd, s_metadata);
  if (meta == nullptr) goto fail;
  {
    PyObject* md = *inst_dict_ptr(meta);
    PyObject* cur;
    PyObject* cp;
    if ((cur = PyDict_GetItemWithError(md, s_labels)) == nullptr) goto fail;
    if ((cp = PyDict_Copy(cur)) == nullptr) goto fail;
    if (PyDict_SetItem(md, s_labels, cp) < 0) { Py_DECREF(cp); goto fail; }
    Py_DECREF(cp);
    if ((cur = PyDict_GetItemWithError(md, s_annotations)) == nullptr)
      goto fail;
    if ((cp = PyDict_Copy(cur)) == nullptr) goto fail;
    if (PyDict_SetItem(md, s_annotations, cp) < 0) { Py_DECREF(cp); goto fail; }
    Py_DECREF(cp);
  }
  if (privatize_member(nd, s_spec) == nullptr) goto fail;
  {
    PyObject* status = privatize_member(nd, s_status);
    if (status == nullptr) goto fail;
    PyObject* sd = *inst_dict_ptr(status);
    PyObject* cur = PyDict_GetItemWithError(sd, s_conditions);
    if (cur == nullptr) goto fail;
    PyObject* cp = list_copy(cur);
    if (cp == nullptr) goto fail;
    if (PyDict_SetItem(sd, s_conditions, cp) < 0) { Py_DECREF(cp); goto fail; }
    Py_DECREF(cp);
  }
  return neu;
fail:
  Py_DECREF(neu);
  return nullptr;
}

// store.store._make_event, exactly (same dict insertion order).
PyObject* make_event(PyObject* etype, PyObject* kind, PyObject* obj,
                     PyObject* rv, PyObject* prev, PyObject* lazy,
                     PyObject* ts) {
  PyObject* d = PyDict_New();
  if (d == nullptr) return nullptr;
  if (PyDict_SetItem(d, s_type, etype) < 0 ||
      PyDict_SetItem(d, s_kind, kind) < 0 ||
      PyDict_SetItem(d, s_obj, obj) < 0 ||
      PyDict_SetItem(d, s_resource_version, rv) < 0 ||
      PyDict_SetItem(d, s_prev, prev) < 0 ||
      PyDict_SetItem(d, s_lazy, lazy) < 0 ||
      PyDict_SetItem(d, s_commit_ts, ts) < 0) {
    Py_DECREF(d);
    return nullptr;
  }
  PyTypeObject* tp = (PyTypeObject*)g_event_type;
  PyObject* ev = tp->tp_alloc(tp, 0);
  if (ev == nullptr) {
    Py_DECREF(d);
    return nullptr;
  }
  PyObject** ddp = inst_dict_ptr(ev);
  if (ddp == nullptr) {
    Py_DECREF(d);
    Py_DECREF(ev);
    PyErr_SetString(PyExc_TypeError, "hostcommit: Event has no __dict__");
    return nullptr;
  }
  Py_XSETREF(*ddp, d);  // see shallow_copy: 3.11+ may pre-materialize
  return ev;
}

// set clone.spec.node_name (clone's spec is private, plain dict write)
int set_node_name(PyObject* pod, PyObject* node_name) {
  PyObject* own = nullptr;
  PyObject* spec = fast_attr(pod, s_spec, &own);
  if (spec == nullptr) return -1;
  PyObject** sdp = inst_dict_ptr(spec);
  int rc;
  if (sdp != nullptr && *sdp != nullptr)
    rc = PyDict_SetItem(*sdp, s_node_name, node_name);
  else
    rc = PyObject_SetAttr(spec, s_node_name, node_name);
  Py_XDECREF(own);
  return rc;
}

// pod.key with the property's memo semantics (the property call on a miss
// computes AND caches — parity by construction)
PyObject* pod_key(PyObject* pod) {  // new ref
  PyObject** dp = inst_dict_ptr(pod);
  if (dp != nullptr && *dp != nullptr) {
    PyObject* k = PyDict_GetItemWithError(*dp, s_key_cache);
    if (k != nullptr) {
      Py_INCREF(k);
      return k;
    }
    if (PyErr_Occurred()) return nullptr;
  }
  return PyObject_GetAttr(pod, s_key);
}

int append_error(PyObject* errors, PyObject* key, PyObject* msg_owned) {
  if (msg_owned == nullptr) return -1;
  PyObject* t = PyTuple_Pack(2, key, msg_owned);
  Py_DECREF(msg_owned);
  if (t == nullptr) return -1;
  int rc = PyList_Append(errors, t);
  Py_DECREF(t);
  return rc;
}

int ensure_ready() {
  if (!g_ready) {
    PyErr_SetString(PyExc_RuntimeError, "hostcommit: hc_init not called");
    return -1;
  }
  return 0;
}

// Unpack one entry that is USUALLY a tuple but — like the Python oracles'
// `for a, b in pairs` — may be any sequence of the right arity. Fills out[]
// with refs borrowed from the entry (tuple fast path, *owned NULL) or from
// *owned (caller must Py_XDECREF it when done with the values). A
// wrong-arity entry raises, matching the oracle's unpack ValueError.
int unpack_entry(PyObject* item, Py_ssize_t want, PyObject** out,
                 PyObject** owned, const char* what) {
  *owned = nullptr;
  if (PyTuple_Check(item) && PyTuple_GET_SIZE(item) == want) {
    for (Py_ssize_t i = 0; i < want; ++i) out[i] = PyTuple_GET_ITEM(item, i);
    return 0;
  }
  PyObject* f = PySequence_Fast(item, what);
  if (f == nullptr) return -1;
  if (PySequence_Fast_GET_SIZE(f) != want) {
    Py_DECREF(f);
    PyErr_SetString(PyExc_ValueError, what);
    return -1;
  }
  PyObject** its = PySequence_Fast_ITEMS(f);
  for (Py_ssize_t i = 0; i < want; ++i) out[i] = its[i];
  *owned = f;
  return 0;
}

}  // namespace

extern "C" {

// One-time setup: type references + interned strings. Called by the loader
// (kubernetes_tpu_torch/native/hostcommit.py) under its module lock.
PyObject* hc_init(PyObject* event_type, PyObject* podinfo_type,
                  PyObject* nodeinfo_type) {
  if (!g_ready) {
#define INTERN(var, lit)                     \
  var = PyUnicode_InternFromString(lit);     \
  if (var == nullptr) return nullptr
    INTERN(s_metadata, "metadata");
    INTERN(s_spec, "spec");
    INTERN(s_status, "status");
    INTERN(s_node_name, "node_name");
    INTERN(s_resource_version, "resource_version");
    INTERN(s_labels, "labels");
    INTERN(s_annotations, "annotations");
    INTERN(s_conditions, "conditions");
    INTERN(s_type, "type");
    INTERN(s_kind, "kind");
    INTERN(s_obj, "obj");
    INTERN(s_prev, "prev");
    INTERN(s_lazy, "lazy");
    INTERN(s_commit_ts, "commit_ts");
    INTERN(s_key, "key");
    INTERN(s_key_cache, "_key_cache");
    INTERN(s_req_cache, "_req_cache");
    INTERN(s_class_sig, "_class_sig");
    INTERN(s_req_sig, "_req_sig");
    INTERN(s_pods, "pods");
    INTERN(s_pods_with_affinity, "pods_with_affinity");
    INTERN(s_pods_with_req_anti, "pods_with_required_anti_affinity");
    INTERN(s_affinity, "affinity");
    INTERN(s_pod_aff_req, "pod_affinity_required");
    INTERN(s_pod_anti_req, "pod_anti_affinity_required");
    INTERN(s_pod_aff_pref, "pod_affinity_preferred");
    INTERN(s_pod_anti_pref, "pod_anti_affinity_preferred");
    INTERN(s_slot_pod, "pod");
    INTERN(s_slot_request, "request");
    INTERN(s_slot_nz_request, "non_zero_request");
    INTERN(s_slot_req_aff, "required_affinity_terms");
    INTERN(s_slot_req_anti, "required_anti_affinity_terms");
    INTERN(s_slot_pref_aff, "preferred_affinity_terms");
    INTERN(s_slot_pref_anti, "preferred_anti_affinity_terms");
    INTERN(s_kind_pods, "pods");
#undef INTERN
    g_empty_tuple = PyTuple_New(0);
    if (g_empty_tuple == nullptr) return nullptr;
    g_zero_float = PyFloat_FromDouble(0.0);
    if (g_zero_float == nullptr) return nullptr;
  }
  Py_XDECREF(g_event_type);
  Py_XDECREF(g_podinfo_type);
  Py_XDECREF(g_nodeinfo_type);
  Py_INCREF(event_type);
  Py_INCREF(podinfo_type);
  Py_INCREF(nodeinfo_type);
  g_event_type = event_type;
  g_podinfo_type = podinfo_type;
  g_nodeinfo_type = nodeinfo_type;
  g_ready = true;
  Py_RETURN_NONE;
}

// bind_many phase 1 (validate + clone, caller holds the pods shard):
// bindings = iterable of (namespace, name, node_name); appends
// (key, old stored pod, new clone, node_name) to `prepared` and
// (key, message) to `errors`. Returns None.
PyObject* hc_bind_prepare(PyObject* pods, PyObject* bindings,
                          PyObject* prepared, PyObject* errors) {
  if (ensure_ready() < 0) return nullptr;
  PyObject* fast = PySequence_Fast(bindings, "bindings must be iterable");
  if (fast == nullptr) return nullptr;
  Py_ssize_t n = PySequence_Fast_GET_SIZE(fast);
  PyObject** items = PySequence_Fast_ITEMS(fast);
  // non-tuple entries' values borrow from this slot (unpack_entry); cleared
  // at every iteration boundary, released once more on the fail path
  PyObject* trip_owned = nullptr;
  for (Py_ssize_t i = 0; i < n; ++i) {
    PyObject* trip[3];
    if (unpack_entry(items[i], 3, trip, &trip_owned,
                     "bindings must be (namespace, name, node) triples") < 0)
      goto fail;
    {
      PyObject* ns = trip[0];
      PyObject* name = trip[1];
      PyObject* node = trip[2];
      PyObject* key = PyUnicode_FromFormat("%S/%S", ns, name);
      if (key == nullptr) goto fail;
      PyObject* pod = PyDict_GetItemWithError(pods, key);
      if (pod == nullptr) {
        if (PyErr_Occurred()) {
          Py_DECREF(key);
          goto fail;
        }
        if (append_error(errors, key,
                         PyUnicode_FromFormat("pods %U not found", key)) < 0) {
          Py_DECREF(key);
          goto fail;
        }
        Py_DECREF(key);
        Py_CLEAR(trip_owned);
        continue;
      }
      PyObject* own = nullptr;
      PyObject* spec = fast_attr(pod, s_spec, &own);
      if (spec == nullptr) {
        Py_DECREF(key);
        goto fail;
      }
      PyObject* own2 = nullptr;
      PyObject* cur_node = fast_attr(spec, s_node_name, &own2);
      if (cur_node == nullptr) {
        Py_XDECREF(own);
        Py_DECREF(key);
        goto fail;
      }
      int bound = PyObject_IsTrue(cur_node);
      if (bound < 0) {
        Py_XDECREF(own2);
        Py_XDECREF(own);
        Py_DECREF(key);
        goto fail;
      }
      if (bound) {
        int rc = append_error(
            errors, key,
            PyUnicode_FromFormat("pod %U is already bound to %S", key,
                                 cur_node));
        Py_XDECREF(own2);
        Py_XDECREF(own);
        Py_DECREF(key);
        if (rc < 0) goto fail;
        Py_CLEAR(trip_owned);
        continue;
      }
      Py_XDECREF(own2);
      Py_XDECREF(own);
      PyObject* neu = bind_clone(pod);
      if (neu == nullptr) {
        Py_DECREF(key);
        goto fail;
      }
      if (set_node_name(neu, node) < 0) {
        Py_DECREF(neu);
        Py_DECREF(key);
        goto fail;
      }
      PyObject* entry = PyTuple_Pack(4, key, pod, neu, node);
      Py_DECREF(neu);
      Py_DECREF(key);
      if (entry == nullptr) goto fail;
      int rc = PyList_Append(prepared, entry);
      Py_DECREF(entry);
      if (rc < 0) goto fail;
    }
    Py_CLEAR(trip_owned);
  }
  Py_DECREF(fast);
  Py_RETURN_NONE;
fail:
  Py_XDECREF(trip_owned);
  Py_DECREF(fast);
  return nullptr;
}

// Columnar bind_many phase 1 (caller holds the pods shard):
// validate each (namespace, name, node) triple against the COLUMN ARRAYS —
// key2row lookup + node_id[row] bound check — and intern the node names,
// with NO clone and no object walk. Outputs: rows_out/ids_out (int32,
// caller-allocated at len(bindings); the first `count` entries are valid),
// keys_out (list, one key string per accepted entry), errors (list of
// (key, message), byte-identical to the Python loop in
// store/columnar.py PodColumns.bind_prepare). Returns count.
PyObject* hc_columnar_prepare(PyObject* key2row, PyObject* bindings,
                              PyObject* node_ids, PyObject* node_names,
                              PyObject* errors, PyObject* keys_out,
                              int32_t* node_id_col, int32_t* rows_out,
                              int32_t* ids_out) {
  if (ensure_ready() < 0) return nullptr;
  PyObject* fast = PySequence_Fast(bindings, "bindings must be iterable");
  if (fast == nullptr) return nullptr;
  Py_ssize_t n = PySequence_Fast_GET_SIZE(fast);
  PyObject** items = PySequence_Fast_ITEMS(fast);
  PyObject* trip_owned = nullptr;
  long count = 0;
  for (Py_ssize_t i = 0; i < n; ++i) {
    PyObject* trip[3];
    if (unpack_entry(items[i], 3, trip, &trip_owned,
                     "bindings must be (namespace, name, node) triples") < 0)
      goto fail;
    {
      PyObject* key = PyUnicode_FromFormat("%S/%S", trip[0], trip[1]);
      if (key == nullptr) goto fail;
      PyObject* row_obj = PyDict_GetItemWithError(key2row, key);
      if (row_obj == nullptr) {
        if (PyErr_Occurred()) {
          Py_DECREF(key);
          goto fail;
        }
        if (append_error(errors, key,
                         PyUnicode_FromFormat("pods %U not found", key)) < 0) {
          Py_DECREF(key);
          goto fail;
        }
        Py_DECREF(key);
        Py_CLEAR(trip_owned);
        continue;
      }
      long row = PyLong_AsLong(row_obj);
      if (row == -1 && PyErr_Occurred()) {
        Py_DECREF(key);
        goto fail;
      }
      int32_t cur = node_id_col[row];
      if (cur >= 0) {
        PyObject* cur_name = PyList_GetItem(node_names, (Py_ssize_t)cur);
        if (cur_name == nullptr) {
          Py_DECREF(key);
          goto fail;
        }
        int rc = append_error(
            errors, key,
            PyUnicode_FromFormat("pod %U is already bound to %S", key,
                                 cur_name));
        Py_DECREF(key);
        if (rc < 0) goto fail;
        Py_CLEAR(trip_owned);
        continue;
      }
      PyObject* node = trip[2];
      long nid;
      PyObject* nid_obj = PyDict_GetItemWithError(node_ids, node);
      if (nid_obj == nullptr) {
        if (PyErr_Occurred()) {
          Py_DECREF(key);
          goto fail;
        }
        nid = (long)PyList_GET_SIZE(node_names);
        PyObject* nid_new = PyLong_FromLong(nid);
        if (nid_new == nullptr) {
          Py_DECREF(key);
          goto fail;
        }
        // append BEFORE the dict insert: if the second step fails, the
        // shared intern table holds only a harmless orphan list entry —
        // the reverse order would leave a dict id past the table's end,
        // and a LATER bind of this node name would index out of range
        int rc = PyList_Append(node_names, node);
        if (rc == 0) rc = PyDict_SetItem(node_ids, node, nid_new);
        Py_DECREF(nid_new);
        if (rc < 0) {
          Py_DECREF(key);
          goto fail;
        }
      } else {
        nid = PyLong_AsLong(nid_obj);
        if (nid == -1 && PyErr_Occurred()) {
          Py_DECREF(key);
          goto fail;
        }
      }
      int rc = PyList_Append(keys_out, key);
      Py_DECREF(key);
      if (rc < 0) goto fail;
      rows_out[count] = (int32_t)row;
      ids_out[count] = (int32_t)nid;
      count += 1;
    }
    Py_CLEAR(trip_owned);
  }
  Py_DECREF(fast);
  return PyLong_FromLong(count);
fail:
  Py_XDECREF(trip_owned);
  Py_DECREF(fast);
  return nullptr;
}

// bind_many phase 2 (commit, caller holds global + shard): stamps a
// contiguous RV range, swaps rows, builds one event per bind. mode: 0 =
// share (store without isolation copies), 1 = lazy (event shares the stored
// object, lazy slot [None, cloner]), 2 = eager (event carries its own
// clone). Returns (final_rv, bound_count).
PyObject* hc_bind_commit(PyObject* pods, PyObject* prepared, PyObject* events,
                         PyObject* errors, long rv0, int mode,
                         PyObject* ts_obj, PyObject* cloner,
                         PyObject* etype) {
  if (ensure_ready() < 0) return nullptr;
  long rv = rv0;
  long bound = 0;
  Py_ssize_t n = PyList_GET_SIZE(prepared);
  for (Py_ssize_t i = 0; i < n; ++i) {
    PyObject* entry = PyList_GET_ITEM(prepared, i);
    PyObject* key = PyTuple_GET_ITEM(entry, 0);
    PyObject* old = PyTuple_GET_ITEM(entry, 1);
    PyObject* neu = PyTuple_GET_ITEM(entry, 2);  // borrowed unless raced
    PyObject* node = PyTuple_GET_ITEM(entry, 3);
    PyObject* neu_owned = nullptr;
    PyObject* old_owned = nullptr;  // strong ref for the raced branch: the
    // row swap below drops the dict's (possibly sole) reference to cur,
    // and the event's prev must outlive it — same reason hc_delete_commit
    // INCREFs old (the Python oracle holds `old` in a strong local)
    PyObject* cur = PyDict_GetItemWithError(pods, key);
    if (cur == nullptr && PyErr_Occurred()) return nullptr;
    if (cur != old) {
      // raced between the phases: re-validate against the current row
      if (cur == nullptr) {
        if (append_error(errors, key,
                         PyUnicode_FromFormat("pods %U not found", key)) < 0)
          return nullptr;
        continue;
      }
      PyObject* own = nullptr;
      PyObject* spec = fast_attr(cur, s_spec, &own);
      if (spec == nullptr) return nullptr;
      PyObject* own2 = nullptr;
      PyObject* cur_node = fast_attr(spec, s_node_name, &own2);
      if (cur_node == nullptr) {
        Py_XDECREF(own);
        return nullptr;
      }
      int is_bound = PyObject_IsTrue(cur_node);
      if (is_bound < 0) {
        Py_XDECREF(own2);
        Py_XDECREF(own);
        return nullptr;
      }
      if (is_bound) {
        int rc = append_error(
            errors, key,
            PyUnicode_FromFormat("pod %U is already bound to %S", key,
                                 cur_node));
        Py_XDECREF(own2);
        Py_XDECREF(own);
        if (rc < 0) return nullptr;
        continue;
      }
      Py_XDECREF(own2);
      Py_XDECREF(own);
      Py_INCREF(cur);
      old_owned = cur;
      old = cur;
      neu_owned = bind_clone(cur);
      if (neu_owned == nullptr) {
        Py_DECREF(old_owned);
        return nullptr;
      }
      if (set_node_name(neu_owned, node) < 0) {
        Py_DECREF(neu_owned);
        Py_DECREF(old_owned);
        return nullptr;
      }
      neu = neu_owned;
    }
    rv += 1;
    PyObject* rv_obj = PyLong_FromLong(rv);
    if (rv_obj == nullptr) {
      Py_XDECREF(neu_owned);
      Py_XDECREF(old_owned);
      return nullptr;
    }
    // neu.metadata.resource_version = rv (metadata is the private clone)
    {
      PyObject* own = nullptr;
      PyObject* meta = fast_attr(neu, s_metadata, &own);
      if (meta == nullptr) {
        Py_DECREF(rv_obj);
        Py_XDECREF(neu_owned);
        Py_XDECREF(old_owned);
        return nullptr;
      }
      PyObject** mdp = inst_dict_ptr(meta);
      int rc = (mdp != nullptr && *mdp != nullptr)
                   ? PyDict_SetItem(*mdp, s_resource_version, rv_obj)
                   : PyObject_SetAttr(meta, s_resource_version, rv_obj);
      Py_XDECREF(own);
      if (rc < 0) {
        Py_DECREF(rv_obj);
        Py_XDECREF(neu_owned);
        Py_XDECREF(old_owned);
        return nullptr;
      }
    }
    if (PyDict_SetItem(pods, key, neu) < 0) {
      Py_DECREF(rv_obj);
      Py_XDECREF(neu_owned);
      Py_XDECREF(old_owned);
      return nullptr;
    }
    PyObject* ev = nullptr;
    if (mode == 1) {
      PyObject* lazy = PyList_New(2);
      if (lazy != nullptr) {
        Py_INCREF(Py_None);
        PyList_SET_ITEM(lazy, 0, Py_None);
        Py_INCREF(cloner);
        PyList_SET_ITEM(lazy, 1, cloner);
        ev = make_event(etype, s_kind_pods, neu, rv_obj, old, lazy, ts_obj);
        Py_DECREF(lazy);
      }
    } else if (mode == 2) {
      PyObject* evobj = bind_clone(neu);
      if (evobj != nullptr) {
        ev = make_event(etype, s_kind_pods, evobj, rv_obj, old, Py_None,
                        ts_obj);
        Py_DECREF(evobj);
      }
    } else {
      ev = make_event(etype, s_kind_pods, neu, rv_obj, old, Py_None, ts_obj);
    }
    Py_DECREF(rv_obj);
    Py_XDECREF(neu_owned);
    Py_XDECREF(old_owned);  // the event holds its own ref to prev now
    if (ev == nullptr) return nullptr;
    int rc = PyList_Append(events, ev);
    Py_DECREF(ev);
    if (rc < 0) return nullptr;
    bound += 1;
  }
  return Py_BuildValue("ll", rv, bound);
}

// Batched pod delete commit (caller holds global + shard): ONE structural
// clone per pod stamped at its post-delete RV, DELETED events in the same
// lazy/eager/share modes as bind. BUILD-THEN-POP: every clone and event is
// constructed BEFORE any row is removed, so a mid-batch failure (clone
// error, OOM) leaves the store untouched — no popped-but-never-narrated
// pods. A duplicate key in one batch errors like the pop it replaces
// ("not found" on the second occurrence). Returns (final_rv, deleted).
PyObject* hc_delete_commit(PyObject* pods, PyObject* keys, PyObject* events,
                           PyObject* errors, long rv0, int mode,
                           PyObject* ts_obj, PyObject* cloner,
                           PyObject* etype) {
  if (ensure_ready() < 0) return nullptr;
  PyObject* fast = PySequence_Fast(keys, "keys must be iterable");
  if (fast == nullptr) return nullptr;
  PyObject* found = PyList_New(0);  // keys to pop, in order
  if (found == nullptr) {
    Py_DECREF(fast);
    return nullptr;
  }
  PyObject* seen = PySet_New(nullptr);  // dup keys behave like the old pop
  if (seen == nullptr) {
    Py_DECREF(found);
    Py_DECREF(fast);
    return nullptr;
  }
  Py_ssize_t n = PySequence_Fast_GET_SIZE(fast);
  PyObject** items = PySequence_Fast_ITEMS(fast);
  long rv = rv0;
  long deleted = 0;
  for (Py_ssize_t i = 0; i < n; ++i) {
    PyObject* key = items[i];
    int dup = PySet_Contains(seen, key);
    if (dup < 0) goto fail;
    PyObject* old = dup ? nullptr : PyDict_GetItemWithError(pods, key);
    if (old == nullptr) {
      if (PyErr_Occurred()) goto fail;
      if (append_error(errors, key,
                       PyUnicode_FromFormat("pods %S not found", key)) < 0)
        goto fail;
      continue;
    }
    Py_INCREF(old);  // keep alive across the later row removal
    if (PySet_Add(seen, key) < 0 || PyList_Append(found, key) < 0) {
      Py_DECREF(old);
      goto fail;
    }
    rv += 1;
    {
      PyObject* obj;  // the stamped post-delete object
      if (mode == 0) {
        obj = old;
        Py_INCREF(obj);
      } else {
        obj = structural_clone(old);
      }
      if (obj == nullptr) {
        Py_DECREF(old);
        goto fail;
      }
      PyObject* rv_obj = PyLong_FromLong(rv);
      if (rv_obj == nullptr) {
        Py_DECREF(obj);
        Py_DECREF(old);
        goto fail;
      }
      PyObject* own = nullptr;
      PyObject* meta = fast_attr(obj, s_metadata, &own);
      int rc = -1;
      if (meta != nullptr) {
        PyObject** mdp = inst_dict_ptr(meta);
        rc = (mdp != nullptr && *mdp != nullptr)
                 ? PyDict_SetItem(*mdp, s_resource_version, rv_obj)
                 : PyObject_SetAttr(meta, s_resource_version, rv_obj);
      }
      Py_XDECREF(own);
      if (rc < 0) {
        Py_DECREF(rv_obj);
        Py_DECREF(obj);
        Py_DECREF(old);
        goto fail;
      }
      PyObject* ev = nullptr;
      if (mode == 1) {
        PyObject* lazy = PyList_New(2);
        if (lazy != nullptr) {
          Py_INCREF(Py_None);
          PyList_SET_ITEM(lazy, 0, Py_None);
          Py_INCREF(cloner);
          PyList_SET_ITEM(lazy, 1, cloner);
          ev = make_event(etype, s_kind_pods, obj, rv_obj, old, lazy, ts_obj);
          Py_DECREF(lazy);
        }
      } else if (mode == 2) {
        PyObject* evobj = structural_clone(obj);
        if (evobj != nullptr) {
          ev = make_event(etype, s_kind_pods, evobj, rv_obj, old, Py_None,
                          ts_obj);
          Py_DECREF(evobj);
        }
      } else {
        ev = make_event(etype, s_kind_pods, obj, rv_obj, old, Py_None, ts_obj);
      }
      Py_DECREF(rv_obj);
      Py_DECREF(obj);
      Py_DECREF(old);
      if (ev == nullptr) goto fail;
      rc = PyList_Append(events, ev);
      Py_DECREF(ev);
      if (rc < 0) goto fail;
      deleted += 1;
    }
  }
  // pop phase: everything narratable was built — removals cannot fail for
  // keys we just read under the lock the caller still holds
  for (Py_ssize_t i = 0; i < PyList_GET_SIZE(found); ++i) {
    if (PyDict_DelItem(pods, PyList_GET_ITEM(found, i)) < 0) goto fail;
  }
  Py_DECREF(seen);
  Py_DECREF(found);
  Py_DECREF(fast);
  return Py_BuildValue("ll", rv, deleted);
fail:
  Py_DECREF(seen);
  Py_DECREF(found);
  Py_DECREF(fast);
  return nullptr;
}

// Cache.assume_pods_structural's per-pod loop (caller holds the cache lock,
// check_ports=False form): pairs = [(pod, node_name)]. Mutates pod_nodes /
// assumed / nodes exactly like the Python loop; appends (index, message) to
// `failed`. Returns None.
PyObject* hc_assume_structural(PyObject* pairs, PyObject* pod_nodes,
                               PyObject* assumed, PyObject* nodes,
                               PyObject* failed) {
  if (ensure_ready() < 0) return nullptr;
  PyObject* fast = PySequence_Fast(pairs, "pairs must be iterable");
  if (fast == nullptr) return nullptr;
  Py_ssize_t n = PySequence_Fast_GET_SIZE(fast);
  PyObject** items = PySequence_Fast_ITEMS(fast);
  // non-tuple entries' values borrow from this slot (unpack_entry; the
  // Python oracle's `for pod, node_name in pairs` unpacks any 2-sequence);
  // cleared at every iteration boundary, released once more on fail
  PyObject* pair_owned = nullptr;
  for (Py_ssize_t i = 0; i < n; ++i) {
    PyObject* pr[2];
    if (unpack_entry(items[i], 2, pr, &pair_owned,
                     "pairs must be (pod, node_name) entries") < 0)
      goto fail;
    PyObject* pod = pr[0];
    PyObject* node_name = pr[1];
    PyObject* key = pod_key(pod);
    if (key == nullptr) goto fail;
    int has = PyDict_Contains(pod_nodes, key);
    if (has < 0) {
      Py_DECREF(key);
      goto fail;
    }
    if (has) {
      PyObject* msg =
          PyUnicode_FromFormat("pod %U is already in the cache", key);
      Py_DECREF(key);
      if (msg == nullptr) goto fail;
      PyObject* idx = PyLong_FromSsize_t(i);
      if (idx == nullptr) {
        Py_DECREF(msg);
        goto fail;
      }
      PyObject* t = PyTuple_Pack(2, idx, msg);
      Py_DECREF(idx);
      Py_DECREF(msg);
      if (t == nullptr) goto fail;
      int rc = PyList_Append(failed, t);
      Py_DECREF(t);
      if (rc < 0) goto fail;
      Py_CLEAR(pair_owned);
      continue;
    }
    if (set_node_name(pod, node_name) < 0) {
      Py_DECREF(key);
      goto fail;
    }
    PyObject* ni = PyDict_GetItemWithError(nodes, node_name);
    if (ni == nullptr) {
      if (PyErr_Occurred()) {
        Py_DECREF(key);
        goto fail;
      }
      PyObject* ni_new = PyObject_CallNoArgs(g_nodeinfo_type);
      if (ni_new == nullptr) {
        Py_DECREF(key);
        goto fail;
      }
      if (PyDict_SetItem(nodes, node_name, ni_new) < 0) {
        Py_DECREF(ni_new);
        Py_DECREF(key);
        goto fail;
      }
      Py_DECREF(ni_new);
      ni = PyDict_GetItemWithError(nodes, node_name);
      if (ni == nullptr) {
        Py_DECREF(key);
        goto fail;
      }
    }
    // PodInfo(pod), fast path when the request pair is memoized (the
    // tensorizer seeds it); cold pods take the Python constructor
    PyObject* pi = nullptr;
    int any_aff = 0;
    int req_anti = 0;
    {
      PyObject** pdp = inst_dict_ptr(pod);
      PyObject* cached = (pdp != nullptr && *pdp != nullptr)
                             ? PyDict_GetItemWithError(*pdp, s_req_cache)
                             : nullptr;
      if (cached == nullptr && PyErr_Occurred()) {
        Py_DECREF(key);
        goto fail;
      }
      if (cached == nullptr || !PyTuple_Check(cached) ||
          PyTuple_GET_SIZE(cached) != 2) {
        pi = PyObject_CallOneArg(g_podinfo_type, pod);
        if (pi == nullptr) {
          Py_DECREF(key);
          goto fail;
        }
        PyObject* t1 = PyObject_GetAttr(pi, s_slot_req_aff);
        PyObject* t2 = PyObject_GetAttr(pi, s_slot_req_anti);
        PyObject* t3 = PyObject_GetAttr(pi, s_slot_pref_aff);
        PyObject* t4 = PyObject_GetAttr(pi, s_slot_pref_anti);
        if (t1 == nullptr || t2 == nullptr || t3 == nullptr || t4 == nullptr) {
          Py_XDECREF(t1);
          Py_XDECREF(t2);
          Py_XDECREF(t3);
          Py_XDECREF(t4);
          Py_DECREF(pi);
          Py_DECREF(key);
          goto fail;
        }
        req_anti = PyObject_IsTrue(t2);
        any_aff = (PyObject_IsTrue(t1) || req_anti || PyObject_IsTrue(t3) ||
                   PyObject_IsTrue(t4));
        Py_DECREF(t1);
        Py_DECREF(t2);
        Py_DECREF(t3);
        Py_DECREF(t4);
      } else {
        PyTypeObject* tp = (PyTypeObject*)g_podinfo_type;
        pi = tp->tp_alloc(tp, 0);
        if (pi == nullptr) {
          Py_DECREF(key);
          goto fail;
        }
        if (PyObject_SetAttr(pi, s_slot_pod, pod) < 0 ||
            PyObject_SetAttr(pi, s_slot_request,
                             PyTuple_GET_ITEM(cached, 0)) < 0 ||
            PyObject_SetAttr(pi, s_slot_nz_request,
                             PyTuple_GET_ITEM(cached, 1)) < 0) {
          Py_DECREF(pi);
          Py_DECREF(key);
          goto fail;
        }
        PyObject* own = nullptr;
        PyObject* spec = fast_attr(pod, s_spec, &own);
        if (spec == nullptr) {
          Py_DECREF(pi);
          Py_DECREF(key);
          goto fail;
        }
        PyObject* own2 = nullptr;
        PyObject* aff = fast_attr(spec, s_affinity, &own2);
        Py_XDECREF(own);
        if (aff == nullptr) {
          Py_DECREF(pi);
          Py_DECREF(key);
          goto fail;
        }
        int truthy = (aff == Py_None) ? 0 : PyObject_IsTrue(aff);
        if (truthy < 0) {
          Py_XDECREF(own2);
          Py_DECREF(pi);
          Py_DECREF(key);
          goto fail;
        }
        if (!truthy) {
          if (PyObject_SetAttr(pi, s_slot_req_aff, g_empty_tuple) < 0 ||
              PyObject_SetAttr(pi, s_slot_req_anti, g_empty_tuple) < 0 ||
              PyObject_SetAttr(pi, s_slot_pref_aff, g_empty_tuple) < 0 ||
              PyObject_SetAttr(pi, s_slot_pref_anti, g_empty_tuple) < 0) {
            Py_XDECREF(own2);
            Py_DECREF(pi);
            Py_DECREF(key);
            goto fail;
          }
        } else {
          static PyObject** srcs[4] = {&s_pod_aff_req, &s_pod_anti_req,
                                       &s_pod_aff_pref, &s_pod_anti_pref};
          static PyObject** dsts[4] = {&s_slot_req_aff, &s_slot_req_anti,
                                       &s_slot_pref_aff, &s_slot_pref_anti};
          for (int j = 0; j < 4; ++j) {
            PyObject* src = PyObject_GetAttr(aff, *srcs[j]);
            if (src == nullptr) {
              Py_XDECREF(own2);
              Py_DECREF(pi);
              Py_DECREF(key);
              goto fail;
            }
            PyObject* t = PySequence_Tuple(src);
            Py_DECREF(src);
            if (t == nullptr) {
              Py_XDECREF(own2);
              Py_DECREF(pi);
              Py_DECREF(key);
              goto fail;
            }
            int truth = PyTuple_GET_SIZE(t) > 0;
            if (truth) any_aff = 1;
            if (j == 1 && truth) req_anti = 1;
            int rc = PyObject_SetAttr(pi, *dsts[j], t);
            Py_DECREF(t);
            if (rc < 0) {
              Py_XDECREF(own2);
              Py_DECREF(pi);
              Py_DECREF(key);
              goto fail;
            }
          }
        }
        Py_XDECREF(own2);
      }
    }
    // ni.pods.append(pi) (+ affinity sublists)
    {
      PyObject* lst = PyObject_GetAttr(ni, s_pods);
      if (lst == nullptr) {
        Py_DECREF(pi);
        Py_DECREF(key);
        goto fail;
      }
      int rc = PyList_Append(lst, pi);
      Py_DECREF(lst);
      if (rc == 0 && any_aff) {
        lst = PyObject_GetAttr(ni, s_pods_with_affinity);
        if (lst == nullptr)
          rc = -1;
        else {
          rc = PyList_Append(lst, pi);
          Py_DECREF(lst);
        }
        if (rc == 0 && req_anti) {
          lst = PyObject_GetAttr(ni, s_pods_with_req_anti);
          if (lst == nullptr)
            rc = -1;
          else {
            rc = PyList_Append(lst, pi);
            Py_DECREF(lst);
          }
        }
      }
      Py_DECREF(pi);
      if (rc < 0) {
        Py_DECREF(key);
        goto fail;
      }
    }
    if (PyDict_SetItem(pod_nodes, key, node_name) < 0 ||
        PyDict_SetItem(assumed, key, g_zero_float) < 0) {
      Py_DECREF(key);
      goto fail;
    }
    Py_DECREF(key);
    Py_CLEAR(pair_owned);
  }
  Py_DECREF(fast);
  Py_RETURN_NONE;
fail:
  Py_XDECREF(pair_owned);
  Py_DECREF(fast);
  return nullptr;
}

// build_pod_batch's fused per-pod loop (class signature + request-memo row):
// fills class_rows / entry_rows (int32[P], caller-allocated). Misses call
// back into the Python helpers (sig_cb = pod_class_signature, entry_cb =
// the batch-local _req_entry row closure) which own the memoization.
PyObject* hc_batch_rows(PyObject* pods, PyObject* sig_to_class,
                        PyObject* rep_pods, PyObject* req_cache,
                        PyObject* sig_cb, PyObject* entry_cb,
                        int32_t* class_rows, int32_t* entry_rows) {
  if (ensure_ready() < 0) return nullptr;
  PyObject* fast = PySequence_Fast(pods, "pods must be iterable");
  if (fast == nullptr) return nullptr;
  Py_ssize_t n = PySequence_Fast_GET_SIZE(fast);
  PyObject** items = PySequence_Fast_ITEMS(fast);
  for (Py_ssize_t i = 0; i < n; ++i) {
    PyObject* pod = items[i];
    PyObject** pdp = inst_dict_ptr(pod);
    if (pdp == nullptr || *pdp == nullptr) {
      PyErr_SetString(PyExc_TypeError, "pod without instance __dict__");
      goto fail;
    }
    PyObject* pdict = *pdp;
    PyObject* spec = PyDict_GetItemWithError(pdict, s_spec);
    if (spec == nullptr) {
      if (PyErr_Occurred()) goto fail;
      spec = Py_None;  // forces the memo miss path below
    }
    // ---- class signature (memo: (spec, labels, sig), identity-keyed) ----
    PyObject* sig = nullptr;
    PyObject* sig_own = nullptr;
    {
      PyObject* cs = PyDict_GetItemWithError(pdict, s_class_sig);
      if (cs == nullptr && PyErr_Occurred()) goto fail;
      if (cs != nullptr && PyTuple_Check(cs) && PyTuple_GET_SIZE(cs) == 3 &&
          PyTuple_GET_ITEM(cs, 0) == spec) {
        PyObject* meta = PyDict_GetItemWithError(pdict, s_metadata);
        if (meta == nullptr && PyErr_Occurred()) goto fail;
        PyObject* labels = nullptr;
        if (meta != nullptr) {
          PyObject** mdp = inst_dict_ptr(meta);
          if (mdp != nullptr && *mdp != nullptr) {
            labels = PyDict_GetItemWithError(*mdp, s_labels);
            if (labels == nullptr && PyErr_Occurred()) goto fail;
          }
        }
        if (labels != nullptr && PyTuple_GET_ITEM(cs, 1) == labels)
          sig = PyTuple_GET_ITEM(cs, 2);
      }
      if (sig == nullptr) {
        sig_own = PyObject_CallOneArg(sig_cb, pod);
        if (sig_own == nullptr) goto fail;
        sig = sig_own;
      }
    }
    {
      PyObject* ci_obj = PyDict_GetItemWithError(sig_to_class, sig);
      if (ci_obj == nullptr && PyErr_Occurred()) {
        Py_XDECREF(sig_own);
        goto fail;
      }
      long ci;
      if (ci_obj == nullptr) {
        ci = (long)PyList_GET_SIZE(rep_pods);
        PyObject* ci_new = PyLong_FromLong(ci);
        if (ci_new == nullptr) {
          Py_XDECREF(sig_own);
          goto fail;
        }
        int rc = PyDict_SetItem(sig_to_class, sig, ci_new);
        Py_DECREF(ci_new);
        if (rc < 0 || PyList_Append(rep_pods, pod) < 0) {
          Py_XDECREF(sig_own);
          goto fail;
        }
      } else {
        ci = PyLong_AsLong(ci_obj);
        if (ci == -1 && PyErr_Occurred()) {
          Py_XDECREF(sig_own);
          goto fail;
        }
      }
      class_rows[i] = (int32_t)ci;
      Py_XDECREF(sig_own);
    }
    // ---- request-memo row (memo: (spec, sig), identity-keyed) ----
    {
      long entry = -1;
      PyObject* rs = PyDict_GetItemWithError(pdict, s_req_sig);
      if (rs == nullptr && PyErr_Occurred()) goto fail;
      if (rs != nullptr && PyTuple_Check(rs) && PyTuple_GET_SIZE(rs) == 2 &&
          PyTuple_GET_ITEM(rs, 0) == spec) {
        PyObject* got =
            PyDict_GetItemWithError(req_cache, PyTuple_GET_ITEM(rs, 1));
        if (got == nullptr && PyErr_Occurred()) goto fail;
        if (got != nullptr) {
          entry = PyLong_AsLong(PyTuple_GET_ITEM(got, 0));
          if (entry == -1 && PyErr_Occurred()) goto fail;
          // seed the PodInfo request memo exactly like _req_entry does
          if (PyDict_SetDefault(pdict, s_req_cache,
                                PyTuple_GET_ITEM(got, 1)) == nullptr)
            goto fail;
        }
      }
      if (entry < 0) {
        PyObject* e = PyObject_CallOneArg(entry_cb, pod);
        if (e == nullptr) goto fail;
        entry = PyLong_AsLong(e);
        Py_DECREF(e);
        if (entry == -1 && PyErr_Occurred()) goto fail;
      }
      entry_rows[i] = (int32_t)entry;
    }
  }
  Py_DECREF(fast);
  Py_RETURN_NONE;
fail:
  Py_DECREF(fast);
  return nullptr;
}

}  // extern "C"
