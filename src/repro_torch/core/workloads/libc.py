"""Minimal user-space runtime ("libc") in RV64IM+A assembly.

Provides: program entry, syscall wrappers, malloc (brk bump + mmap for
large blocks), threads over ``clone`` (pthread-like spawn/join through
CLONE_CHILD_CLEARTID + futex), spin-then-futex barriers and mutexes (the
synchronisation pattern whose timing sensitivity the paper analyses in
§VI-C2), printing helpers, and a monotonic-clock reader.

Every workload source is concatenated after this text and assembled with
:mod:`repro_torch.core.target.asm`.
"""

LIBC = r"""
# =====================  FASE mini-libc  =====================
.equ SYS_openat, 56
.equ SYS_close, 57
.equ SYS_read, 63
.equ SYS_write, 64
.equ SYS_fstat, 80
.equ SYS_exit, 93
.equ SYS_futex, 98
.equ SYS_clock_gettime, 113
.equ SYS_sched_yield, 124
.equ SYS_brk, 214
.equ SYS_munmap, 215
.equ SYS_clone, 220
.equ SYS_mmap, 222
.equ FUTEX_WAIT, 0
.equ FUTEX_WAKE, 1
.equ SPIN_LIMIT, 200

_start:
    ld a0, 0(sp)          # argc
    addi a1, sp, 8        # argv
    call main
    li a7, SYS_exit
    ecall

__fase_sigreturn:
    li a7, 139
    ecall

# ---- raw syscalls (args already in a0..a5) ----
write:
    li a7, SYS_write
    ecall
    ret
read:
    li a7, SYS_read
    ecall
    ret
openat4:                   # openat(dirfd,path,flags,mode)
    li a7, SYS_openat
    ecall
    ret
close:
    li a7, SYS_close
    ecall
    ret
fstat:
    li a7, SYS_fstat
    ecall
    ret
brk:
    li a7, SYS_brk
    ecall
    ret
mmap6:
    li a7, SYS_mmap
    ecall
    ret
munmap:
    li a7, SYS_munmap
    ecall
    ret
futex3:                    # futex(uaddr, op, val)
    li a7, SYS_futex
    ecall
    ret
sched_yield:
    li a7, SYS_sched_yield
    ecall
    ret
exit:
    li a7, SYS_exit
    ecall

# ---- clock_ns() -> a0 = monotonic ns ----
clock_ns:
    addi sp, sp, -32
    sd ra, 24(sp)
    li a0, 1               # CLOCK_MONOTONIC
    mv a1, sp
    li a7, SYS_clock_gettime
    ecall
    ld t0, 0(sp)           # sec
    ld t1, 8(sp)           # nsec
    li t2, 1000000000
    mul t0, t0, t2
    add a0, t0, t1
    ld ra, 24(sp)
    addi sp, sp, 32
    ret

# ---- strlen(a0) -> a0 ----
strlen:
    mv t0, a0
1:
    lbu t1, 0(a0)
    beqz t1, 2f
    addi a0, a0, 1
    j 1b
2:
    sub a0, a0, t0
    ret

# ---- puts(a0 = str) ----
puts:
    addi sp, sp, -16
    sd ra, 8(sp)
    sd a0, 0(sp)
    call strlen
    mv a2, a0
    ld a1, 0(sp)
    li a0, 1
    call write
    ld ra, 8(sp)
    addi sp, sp, 16
    ret

# ---- print_u64(a0 = value) : decimal, no newline ----
print_u64:
    addi sp, sp, -48
    sd ra, 40(sp)
    addi t0, sp, 32        # write digits backwards from sp+32
    li t1, 10
1:
    remu t2, a0, t1
    addi t2, t2, 48
    addi t0, t0, -1
    sb t2, 0(t0)
    divu a0, a0, t1
    bnez a0, 1b
    addi t3, sp, 32
    sub a2, t3, t0         # len
    mv a1, t0
    li a0, 1
    call write
    ld ra, 40(sp)
    addi sp, sp, 48
    ret

newline:
    addi sp, sp, -16
    sd ra, 8(sp)
    la a1, __nl
    li a0, 1
    li a2, 1
    call write
    ld ra, 8(sp)
    addi sp, sp, 16
    ret

# ---- print_kv(a0=label, a1=value): "label value\n" ----
print_kv:
    addi sp, sp, -32
    sd ra, 24(sp)
    sd a1, 16(sp)
    call puts
    la a1, __sp
    li a0, 1
    li a2, 1
    call write
    ld a0, 16(sp)
    call print_u64
    call newline
    ld ra, 24(sp)
    addi sp, sp, 32
    ret

# ---- atoi(a0 = str) -> a0 ----
atoi:
    li t0, 0
    li t1, 10
1:
    lbu t2, 0(a0)
    li t3, 48
    blt t2, t3, 2f
    li t3, 57
    bgt t2, t3, 2f
    addi t2, t2, -48
    mul t0, t0, t1
    add t0, t0, t2
    addi a0, a0, 1
    j 1b
2:
    mv a0, t0
    ret

# ---- memset(a0=dst, a1=byte, a2=len) word-wise for aligned bulk ----
memset:
    mv t0, a0
    beqz a2, 3f
1:
    andi t1, t0, 7
    bnez t1, 2f
    li t1, 8
    bltu a2, t1, 2f
    # build word of byte
    andi t2, a1, 0xFF
    slli t3, t2, 8
    or t2, t2, t3
    slli t3, t2, 16
    or t2, t2, t3
    slli t3, t2, 32
    or t2, t2, t3
.Lms_words:
    sd t2, 0(t0)
    addi t0, t0, 8
    addi a2, a2, -8
    li t1, 8
    bgeu a2, t1, .Lms_words
2:
    beqz a2, 3f
    sb a1, 0(t0)
    addi t0, t0, 1
    addi a2, a2, -1
    j 2b
3:
    ret

# ---- memcpy(a0=dst, a1=src, a2=len) ----
memcpy:
    mv t0, a0
1:
    li t1, 8
    bltu a2, t1, 2f
    ld t2, 0(a1)
    sd t2, 0(t0)
    addi t0, t0, 8
    addi a1, a1, 8
    addi a2, a2, -8
    j 1b
2:
    beqz a2, 3f
    lbu t2, 0(a1)
    sb t2, 0(t0)
    addi t0, t0, 1
    addi a1, a1, 1
    addi a2, a2, -1
    j 2b
3:
    ret

# ---- malloc(a0 = size) -> a0 ; 16-aligned bump over brk, mmap if large ----
malloc:
    addi sp, sp, -32
    sd ra, 24(sp)
    sd s0, 16(sp)
    addi a0, a0, 15
    andi a0, a0, -16
    mv s0, a0
    li t0, 131072
    bgeu a0, t0, .Lmmap
    la t1, __malloc_cur
    ld t2, 0(t1)
    bnez t2, 1f
    li a0, 0
    call brk               # query current brk
    la t1, __malloc_cur
    sd a0, 0(t1)
    sd a0, 8(t1)           # __malloc_end
    mv t2, a0
1:
    la t1, __malloc_cur
    ld t2, 0(t1)
    add t3, t2, s0
    ld t4, 8(t1)
    bleu t3, t4, 2f
    # grow brk by max(64KB, size)
    li t5, 65536
    bgeu s0, t5, .Lgrow_big
    j .Lgrow_go
.Lgrow_big:
    li t5, 4096
    add t5, s0, t5
.Lgrow_go:
    add a0, t4, t5
    call brk
    la t1, __malloc_cur
    sd a0, 8(t1)
    ld t2, 0(t1)
    add t3, t2, s0
2:
    sd t3, 0(t1)
    mv a0, t2
    ld s0, 16(sp)
    ld ra, 24(sp)
    addi sp, sp, 32
    ret
.Lmmap:
    li t0, 4096
    add s0, s0, t0         # header page for size
    li a0, 0
    mv a1, s0
    li a2, 3               # PROT_READ|PROT_WRITE
    li a3, 0x22            # MAP_PRIVATE|MAP_ANON
    li a4, -1
    li a5, 0
    call mmap6
    sd s0, 0(a0)           # store alloc size in header
    li t0, 0x4D4D41505F4641 # magic "AF_PAMM"-ish
    sd t0, 8(a0)
    li t0, 4096
    add a0, a0, t0
    ld s0, 16(sp)
    ld ra, 24(sp)
    addi sp, sp, 32
    ret

# ---- free(a0 = ptr) : munmap for large blocks, no-op for bump ----
free:
    beqz a0, 1f
    li t0, 4096
    sub t0, a0, t0
    ld t1, 8(t0)
    li t2, 0x4D4D41505F4641
    bne t1, t2, 1f
    ld a1, 0(t0)
    mv a0, t0
    addi sp, sp, -16
    sd ra, 8(sp)
    call munmap
    ld ra, 8(sp)
    addi sp, sp, 16
1:
    ret

# ---- thread_spawn(a0 = fn, a1 = arg) -> a0 = tcb handle ----
# TCB layout at top of a fresh 64KB stack: [tid:u64][fn][arg]
.equ THREAD_STACK, 65536
.equ CLONE_FLAGS, 0x12d1f00  # VM|FS|FILES|SIGHAND|THREAD|SYSVSEM|CHILD_CLEARTID|CHILD_SETTID
thread_spawn:
    addi sp, sp, -48
    sd ra, 40(sp)
    sd s0, 32(sp)
    sd s1, 24(sp)
    mv s0, a0              # fn
    mv s1, a1              # arg
    li a0, 0
    li a1, THREAD_STACK
    li a2, 3
    li a3, 0x22
    li a4, -1
    li a5, 0
    call mmap6             # new stack
    li t0, THREAD_STACK
    add t0, a0, t0
    addi t0, t0, -32       # TCB base
    sd zero, 0(t0)         # tid (kernel sets)
    sd s0, 8(t0)           # fn
    sd s1, 16(t0)          # arg
    li a0, CLONE_FLAGS
    mv a1, t0              # child sp = TCB
    li a2, 0
    li a3, 0
    mv a4, t0              # ctid -> TCB.tid (CLEARTID target)
    li a7, SYS_clone
    ecall
    beqz a0, .Lchild
    # parent: kernel stored the tid via CHILD_SETTID; handle = TCB
    mv a0, a1
    ld s1, 24(sp)
    ld s0, 32(sp)
    ld ra, 40(sp)
    addi sp, sp, 48
    ret
.Lchild:
    ld t0, 8(sp)           # fn   (child sp == TCB)
    ld a0, 16(sp)          # arg
    addi sp, sp, -64       # run below TCB
    jalr ra, 0(t0)
    li a0, 0
    li a7, SYS_exit
    ecall

# ---- thread_join(a0 = tcb handle) ----
thread_join:
    addi sp, sp, -32
    sd ra, 24(sp)
    sd s0, 16(sp)
    mv s0, a0
1:
    lw t0, 0(s0)
    beqz t0, 2f
    mv a0, s0
    li a1, FUTEX_WAIT
    mv a2, t0
    call futex3
    j 1b
2:
    ld s0, 16(sp)
    ld ra, 24(sp)
    addi sp, sp, 32
    ret

# ---- barrier: { count:u64, sense:u32, pad:u32, nthreads:u64 } ----
# barrier_init(a0=b, a1=n)
barrier_init:
    sd zero, 0(a0)
    sw zero, 8(a0)
    sd a1, 16(a0)
    ret

# barrier_wait(a0 = b) — sense-reversing, spin-then-futex
barrier_wait:
    addi sp, sp, -48
    sd ra, 40(sp)
    sd s0, 32(sp)
    sd s1, 24(sp)
    sd s2, 16(sp)
    mv s0, a0
    lw s1, 8(s0)           # current sense
    xori s1, s1, 1         # local sense = !sense
    li t0, 1
    amoadd.d t1, t0, (s0)  # pos = count++
    ld t2, 16(s0)
    addi t2, t2, -1
    bne t1, t2, .Lwaiters
    # last arrival: reset count, flip sense, wake all.  Like GOMP/glibc,
    # wake aggressively: once on the sense word and once on the counter
    # word (threads "that might be blocked", paper SV-B) — the second wake
    # is usually redundant and is what HFutex filters.
    sd zero, 0(s0)
    fence
    sw s1, 8(s0)
    addi a0, s0, 8
    li a1, FUTEX_WAKE
    li a2, 2147483647
    call futex3
    mv a0, s0
    li a1, FUTEX_WAKE
    li a2, 2147483647
    call futex3
    j .Lbdone
.Lwaiters:
    li s2, SPIN_LIMIT
.Lspin:
    lw t3, 8(s0)
    beq t3, s1, .Lbdone
    addi s2, s2, -1
    bnez s2, .Lspin
    # futex fallback: wait while sense unchanged
    lw t3, 8(s0)
    beq t3, s1, .Lbdone
    addi a0, s0, 8
    li a1, FUTEX_WAIT
    xori a2, s1, 1         # old sense value
    call futex3
    li s2, SPIN_LIMIT
    j .Lspin
.Lbdone:
    ld s2, 16(sp)
    ld s1, 24(sp)
    ld s0, 32(sp)
    ld ra, 40(sp)
    addi sp, sp, 48
    ret

# ---- mutex (single u32 word: 0 free, 1 locked, 2 contended) ----
mutex_lock:
    addi sp, sp, -32
    sd ra, 24(sp)
    sd s0, 16(sp)
    mv s0, a0
1:
    lr.w t0, (s0)
    bnez t0, 2f
    li t1, 1
    sc.w t2, t1, (s0)
    bnez t2, 1b
    j 4f
2:  # contended path
    li t1, 2
    amoswap.w t0, t1, (s0)
    beqz t0, 4f
    mv a0, s0
    li a1, FUTEX_WAIT
    li a2, 2
    call futex3
    mv a0, s0
    j 1b
4:
    ld s0, 16(sp)
    ld ra, 24(sp)
    addi sp, sp, 32
    ret

mutex_unlock:
    addi sp, sp, -32
    sd ra, 24(sp)
    amoswap.w t0, zero, (a0)
    li t1, 2
    bne t0, t1, 1f
    li a1, FUTEX_WAKE
    li a2, 1
    call futex3
1:
    ld ra, 24(sp)
    addi sp, sp, 32
    ret

# ---- xorshift64 prng: rand_next(a0=&state) -> a0 ----
rand_next:
    ld t0, 0(a0)
    slli t1, t0, 13
    xor t0, t0, t1
    srli t1, t0, 7
    xor t0, t0, t1
    slli t1, t0, 17
    xor t0, t0, t1
    sd t0, 0(a0)
    mv a0, t0
    ret

.data
__nl: .asciz "\n"
__sp: .asciz " "
.align 3
__malloc_cur: .dword 0
__malloc_end: .dword 0
# =====================  end mini-libc  =====================
"""
