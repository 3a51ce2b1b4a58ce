/* shmalloc — numpy data-allocator routing large buffers to MAP_SHARED
 * anonymous memory.
 *
 * Why: on lazily-backed VMs (firecracker snapshots) PRIVATE anonymous
 * pages demand-fault through the hypervisor at ~17 MB/s, while SHARED
 * anonymous (shmem) pages fault at memory speed (~1.5 GB/s, measured on
 * the previous host VM; ROADMAP D10).  Every large
 * numpy buffer — including the D2H destinations np.asarray() creates
 * for device pulls — goes through numpy's data allocator, so installing
 * a PyDataMem handler that mmaps MAP_SHARED|MAP_ANONYMOUS for sizes
 * >= SHM_THRESHOLD fixes the whole host-side finalize path at once.
 *
 * Every block gets a 64-byte header (magic, kind, size) so free/realloc
 * can tell shm blocks from malloc'd ones; the returned pointer stays
 * 64-byte aligned for mmap'd blocks.  A small locked free-list pools
 * recent mappings by exact size to avoid even the (fast) shm refaults
 * in steady-state streaming.
 *
 * Python interface (module findkmer_shmalloc):
 *   install()   -> activate the handler for all future numpy allocations
 *   stats()     -> dict-ish tuple (shm_live, shm_bytes, pool_hits)
 *
 * The reference has no analog (single C process, no allocator layer);
 * this is environment adaptation, part of the runtime like
 * utils/malloc_tuning.py.
 */

#define PY_SSIZE_T_CLEAN
#include <Python.h>

#define NPY_NO_DEPRECATED_API NPY_1_22_API_VERSION
#define NPY_TARGET_VERSION NPY_1_22_API_VERSION
#include <numpy/arrayobject.h>

#include <pthread.h>
#include <stdint.h>
#include <string.h>
#include <sys/mman.h>

#define SHM_THRESHOLD (1u << 20)  /* 1 MiB: route to shared mmap */
#define HDR 64
#define MAGIC_SHM 0x53484d31u     /* "SHM1" */
#define MAGIC_MAL 0x4d414c31u     /* "MAL1" */
#define POOL_SLOTS 32
#define POOL_MAX_BYTES (20ull << 30) /* cap pooled mappings at 20 GiB */

typedef struct {
    uint32_t magic;
    uint32_t pad;
    size_t map_len;   /* full mapping length incl. header (shm) */
} blk_hdr;

typedef struct {
    void *base;
    size_t map_len;
} pool_ent;

static pool_ent pool[POOL_SLOTS];
static size_t pool_bytes = 0;
static pthread_mutex_t pool_mu = PTHREAD_MUTEX_INITIALIZER;
static size_t shm_live = 0, shm_bytes = 0, pool_hits = 0;

static void *shm_map(size_t map_len)
{
    pthread_mutex_lock(&pool_mu);
    for (int i = 0; i < POOL_SLOTS; i++) {
        if (pool[i].base && pool[i].map_len == map_len) {
            void *p = pool[i].base;
            pool[i].base = NULL;
            pool_bytes -= map_len;
            pool_hits++;
            pthread_mutex_unlock(&pool_mu);
            return p;
        }
    }
    pthread_mutex_unlock(&pool_mu);
    void *p = mmap(NULL, map_len, PROT_READ | PROT_WRITE,
                   MAP_SHARED | MAP_ANONYMOUS, -1, 0);
    return p == MAP_FAILED ? NULL : p;
}

static void shm_unmap(void *base, size_t map_len)
{
    pthread_mutex_lock(&pool_mu);
    if (map_len + pool_bytes <= POOL_MAX_BYTES) {
        for (int i = 0; i < POOL_SLOTS; i++) {
            if (!pool[i].base) {
                pool[i].base = base;
                pool[i].map_len = map_len;
                pool_bytes += map_len;
                pthread_mutex_unlock(&pool_mu);
                return;
            }
        }
    }
    pthread_mutex_unlock(&pool_mu);
    munmap(base, map_len);
}

static void *blk_alloc(size_t size, int zero)
{
    if (size >= SHM_THRESHOLD) {
        size_t map_len = (size + HDR + 4095) & ~(size_t)4095;
        void *base = shm_map(map_len);
        if (base) {
            blk_hdr *h = (blk_hdr *)base;
            h->magic = MAGIC_SHM;
            h->map_len = map_len;
            __atomic_add_fetch(&shm_live, 1, __ATOMIC_RELAXED);
            __atomic_add_fetch(&shm_bytes, map_len, __ATOMIC_RELAXED);
            /* fresh MAP_ANONYMOUS pages are already zero; pooled
             * mappings are not — zero on request */
            if (zero) memset((char *)base + HDR, 0, size);
            return (char *)base + HDR;
        }
        /* fall through to malloc on mmap failure */
    }
    char *base = zero ? calloc(1, size + HDR) : malloc(size + HDR);
    if (!base) return NULL;
    blk_hdr *h = (blk_hdr *)base;
    h->magic = MAGIC_MAL;
    h->map_len = size + HDR;
    return base + HDR;
}

static void blk_free(void *ptr)
{
    if (!ptr) return;
    blk_hdr *h = (blk_hdr *)((char *)ptr - HDR);
    if (h->magic == MAGIC_SHM) {
        __atomic_sub_fetch(&shm_live, 1, __ATOMIC_RELAXED);
        __atomic_sub_fetch(&shm_bytes, h->map_len, __ATOMIC_RELAXED);
        shm_unmap((char *)ptr - HDR, h->map_len);
    } else {
        free((char *)ptr - HDR);
    }
}

static void *h_malloc(void *ctx, size_t size)
{
    (void)ctx;
    return blk_alloc(size ? size : 1, 0);
}

static void *h_calloc(void *ctx, size_t nelem, size_t elsize)
{
    (void)ctx;
    if (elsize && nelem > (size_t)-1 / elsize) return NULL;
    size_t size = nelem * elsize;
    return blk_alloc(size ? size : 1, 1);
}

static void *h_realloc(void *ctx, void *ptr, size_t new_size)
{
    (void)ctx;
    if (!ptr) return blk_alloc(new_size ? new_size : 1, 0);
    blk_hdr *h = (blk_hdr *)((char *)ptr - HDR);
    size_t old_size = h->map_len - HDR;
    if (new_size <= old_size && h->magic == MAGIC_MAL)
        return ptr;  /* shrink in place for malloc'd blocks */
    void *np_ = blk_alloc(new_size ? new_size : 1, 0);
    if (!np_) return NULL;
    memcpy(np_, ptr, old_size < new_size ? old_size : new_size);
    blk_free(ptr);
    return np_;
}

static void h_free(void *ctx, void *ptr, size_t size)
{
    (void)ctx;
    (void)size;
    blk_free(ptr);
}

static PyDataMem_Handler handler = {
    "findkmer_shmalloc",
    1,
    {
        NULL,
        h_malloc,
        h_calloc,
        h_realloc,
        h_free,
    },
};

static PyObject *py_install(PyObject *self, PyObject *args)
{
    (void)self;
    (void)args;
    PyObject *cap =
        PyCapsule_New(&handler, "mem_handler", NULL);
    if (!cap) return NULL;
    PyObject *old = PyDataMem_SetHandler(cap);
    Py_DECREF(cap);
    if (!old) return NULL;
    Py_DECREF(old);
    Py_RETURN_TRUE;
}

static PyObject *py_stats(PyObject *self, PyObject *args)
{
    (void)self;
    (void)args;
    return Py_BuildValue(
        "(nnn)", (Py_ssize_t)shm_live, (Py_ssize_t)shm_bytes,
        (Py_ssize_t)pool_hits);
}

static PyMethodDef methods[] = {
    {"install", py_install, METH_NOARGS,
     "Install the shared-memory numpy data allocator."},
    {"stats", py_stats, METH_NOARGS,
     "(live shm blocks, shm bytes, pool hits)."},
    {NULL, NULL, 0, NULL},
};

static struct PyModuleDef mod = {
    PyModuleDef_HEAD_INIT, "findkmer_shmalloc", NULL, -1, methods,
    NULL, NULL, NULL, NULL,
};

PyMODINIT_FUNC PyInit_findkmer_shmalloc(void)
{
    import_array();
    return PyModule_Create(&mod);
}
