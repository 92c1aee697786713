/* shmalloc.c — LD_PRELOAD malloc interposer routing large allocations to
 * MAP_SHARED anonymous mmap.
 *
 * Why: on this deployment (Firecracker-style microVM with free-page
 * reporting), PRIVATE anonymous memory is demand-paged by the VMM at
 * ~5 MB/s on first touch, and freed pages are immediately returned to the
 * host, so the penalty recurs for every fresh allocation.  SHARED
 * anonymous (shmem) pages are served at RAM speed.  Index builds at
 * GRCh38 scale allocate tens of GB of fresh numpy arrays, which would
 * stall for hours on the private-anon path.
 *
 * Routing: malloc/calloc/realloc/posix_memalign/aligned_alloc of
 * >= 4 MiB -> MAP_SHARED|MAP_ANONYMOUS mmap with a 64-byte magic header;
 * everything else passes through to glibc.  free() recognizes our blocks
 * by page offset (our user pointers sit at offset 64 into a page; glibc's
 * own mmap chunks sit at offset 16) plus the header magic.
 *
 * Opt-in only: LD_PRELOAD=.../shmalloc.so — for index-build-heavy
 * steps.  Not fork-CoW-safe for the big blocks
 * (MAP_SHARED is shared with fork children); safe for fork+exec
 * (subprocess) which is all this project uses.
 */
#define _GNU_SOURCE
#include <dlfcn.h>
#include <errno.h>
#include <stdint.h>
#include <string.h>
#include <sys/mman.h>
#include <unistd.h>

#define THRESH (4UL << 20)
#define MAGIC 0x6764696574313337UL /* "gdiet137" */
#define HDR 64

typedef struct { uint64_t magic, total; } hdr_t;

static void *(*real_malloc)(size_t);
static void *(*real_calloc)(size_t, size_t);
static void *(*real_realloc)(void *, size_t);
static void (*real_free)(void *);
static int (*real_posix_memalign)(void **, size_t, size_t);
static void *(*real_aligned_alloc)(size_t, size_t);

/* dlsym may allocate: serve bootstrap allocations from a static arena */
static char boot_buf[1 << 20];
static size_t boot_off;
static int initing;

static void init(void) {
    if (real_malloc || initing) return;
    initing = 1;
    real_malloc = (void *(*)(size_t))dlsym(RTLD_NEXT, "malloc");
    real_calloc = (void *(*)(size_t, size_t))dlsym(RTLD_NEXT, "calloc");
    real_realloc = (void *(*)(void *, size_t))dlsym(RTLD_NEXT, "realloc");
    real_free = (void (*)(void *))dlsym(RTLD_NEXT, "free");
    real_posix_memalign =
        (int (*)(void **, size_t, size_t))dlsym(RTLD_NEXT, "posix_memalign");
    real_aligned_alloc =
        (void *(*)(size_t, size_t))dlsym(RTLD_NEXT, "aligned_alloc");
    initing = 0;
}

static void *boot_alloc(size_t n) {
    size_t off = (boot_off + 15) & ~(size_t)15;
    if (off + n > sizeof(boot_buf)) return 0;
    boot_off = off + n;
    return boot_buf + off;
}

static int is_boot(const void *p) {
    return (const char *)p >= boot_buf && (const char *)p < boot_buf + sizeof(boot_buf);
}

static void *big_alloc(size_t n) {
    size_t total = (n + HDR + 4095) & ~(size_t)4095;
    void *p = mmap(0, total, PROT_READ | PROT_WRITE,
                   MAP_SHARED | MAP_ANONYMOUS, -1, 0);
    if (p == MAP_FAILED) return 0;
    hdr_t *h = (hdr_t *)p;
    h->magic = MAGIC;
    h->total = total;
    return (char *)p + HDR;
}

static hdr_t *our_hdr(void *p) {
    if (!p || (((uintptr_t)p) & 4095) != HDR) return 0;
    hdr_t *h = (hdr_t *)((char *)p - HDR);
    return h->magic == MAGIC ? h : 0;
}

void *malloc(size_t n) {
    init();
    if (initing || !real_malloc) return boot_alloc(n);
    if (n >= THRESH) {
        void *p = big_alloc(n);
        if (p) return p;
    }
    return real_malloc(n);
}

void *calloc(size_t nm, size_t sz) {
    init();
    if (initing || !real_calloc) {
        size_t n = nm * sz;
        void *p = boot_alloc(n);
        if (p) memset(p, 0, n);
        return p;
    }
    if (sz && nm >= THRESH / sz) {
        void *p = big_alloc(nm * sz); /* fresh shmem is zero-filled */
        if (p) return p;
    }
    return real_calloc(nm, sz);
}

void free(void *p) {
    if (!p || is_boot(p)) return;
    hdr_t *h = our_hdr(p);
    if (h) {
        munmap(h, h->total);
        return;
    }
    init();
    if (real_free) real_free(p);
}

void *realloc(void *p, size_t n) {
    init();
    if (!p) return malloc(n);
    if (is_boot(p)) {
        void *q = malloc(n);
        if (q) memcpy(q, p, n); /* boot blocks are tiny; n bounds the copy */
        return q;
    }
    hdr_t *h = our_hdr(p);
    if (h) {
        /* NOTE: mremap cannot grow a MAP_SHARED-anon mapping past the
         * size of its backing shmem object (SIGBUS on access), so always
         * allocate-copy-unmap */
        size_t old_user = h->total - HDR;
        void *q = n >= THRESH ? big_alloc(n) : (real_malloc ? real_malloc(n) : 0);
        if (!q) return 0;
        memcpy(q, p, n < old_user ? n : old_user);
        munmap(h, h->total);
        return q;
    }
    if (n >= THRESH) {
        /* foreign -> ours: glibc knows the old usable size; copy min(n) via
         * real_realloc first to keep it simple and correct */
        return real_realloc(p, n);
    }
    return real_realloc(p, n);
}

int posix_memalign(void **out, size_t align, size_t n) {
    init();
    if (n >= THRESH && align <= HDR && (HDR % (align ? align : 1)) == 0) {
        void *p = big_alloc(n);
        if (p) {
            *out = p;
            return 0;
        }
    }
    if (real_posix_memalign) return real_posix_memalign(out, align, n);
    *out = malloc(n);
    return *out ? 0 : ENOMEM;
}

void *aligned_alloc(size_t align, size_t n) {
    init();
    if (n >= THRESH && align <= HDR && (HDR % (align ? align : 1)) == 0) {
        void *p = big_alloc(n);
        if (p) return p;
    }
    return real_aligned_alloc ? real_aligned_alloc(align, n) : malloc(n);
}
