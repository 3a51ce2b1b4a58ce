/* shmmap_preload — LD_PRELOAD shim rewriting large PRIVATE anonymous
 * mmaps to SHARED anonymous.
 *
 * On this lazily-backed VM class, PRIVATE anonymous pages are remotely
 * demand-backed (~5-20 MB/s first touch, and degradable to that rate
 * even when warm under host pressure) while SHARED anonymous (shmem)
 * pages run at memory speed (measured on the previous host VM; ROADMAP
 * D10).  findkmer_shmalloc covers numpy buffers; this shim
 * covers everything else that matters — the PJRT/jax host staging
 * buffers D2H transfers land in, glibc malloc's large mmap'd blocks,
 * and arena allocators.
 *
 * Only clearly-safe mappings are rewritten:
 *   anonymous && private && read|write only (no PROT_EXEC)
 *   && length >= 2 MiB && not MAP_STACK/MAP_GROWSDOWN/MAP_FIXED
 *
 * Semantic difference: fork() shares (not COWs) these regions between
 * parent and child.  CPython's subprocess machinery execs immediately
 * without touching the heap, so this is safe here; processes that fork
 * workers which mutate inherited state must not preload this.
 * Kill-switch: unset LD_PRELOAD (the engine works, slower, without it).
 */

#define _GNU_SOURCE
#include <dlfcn.h>
#include <stddef.h>
#include <stdint.h>
#include <sys/mman.h>

#ifndef MAP_STACK
#define MAP_STACK 0x20000
#endif
#ifndef MAP_GROWSDOWN
#define MAP_GROWSDOWN 0x0100
#endif

#define SHM_MIN_LEN (2ull << 20)

typedef void *(*mmap_fn)(void *, size_t, int, int, int, long);

static int rewrite_flags(size_t length, int prot, int flags, int fd)
{
    if (fd != -1) return flags;
    if (length < SHM_MIN_LEN) return flags;
    if (!(flags & MAP_ANONYMOUS)) return flags;
    if (!(flags & MAP_PRIVATE)) return flags;
    if (flags & (MAP_STACK | MAP_GROWSDOWN | MAP_FIXED)) return flags;
    if (prot & PROT_EXEC) return flags;
    return (flags & ~MAP_PRIVATE) | MAP_SHARED;
}

void *mmap(void *addr, size_t length, int prot, int flags, int fd,
           off_t offset)
{
    static mmap_fn real = NULL;
    if (!real) real = (mmap_fn)dlsym(RTLD_NEXT, "mmap");
    return real(addr, length, prot,
                rewrite_flags(length, prot, flags, fd), fd, offset);
}

void *mmap64(void *addr, size_t length, int prot, int flags, int fd,
             off_t offset)
{
    static mmap_fn real = NULL;
    if (!real) real = (mmap_fn)dlsym(RTLD_NEXT, "mmap64");
    return real(addr, length, prot,
                rewrite_flags(length, prot, flags, fd), fd, offset);
}
