"""GAPBS-like OpenMP-style graph benchmarks in RV64 assembly.

Six kernels mirroring the paper's benchmark suite (§VI-A3): BC, BFS, CCSV,
PR, SSSP, TC.  Usage: ``prog <graph-file> <threads> <trials>``.  Each trial
is timed with ``clock_gettime`` exactly like GAPBS (per-trial for most;
SSSP additionally times every relaxation round — the 40-400x higher
``clock_gettime`` frequency the paper identifies as its error source,
§VI-C2; TC re-allocates a large workspace every trial — the mmap/brk churn
of §VI-C3).

Graph file: u64 header [n, m, has_weights] then rowptr (n+1), colidx (m),
weights (m, optional).  Undirected (symmetrised), adjacency sorted.

Deviations from GAPBS noted in DESIGN.md: PR/BC use Q32.32 fixed point (no
FPU in the target subset), CC is min-label propagation (Shiloach-Vishkin's
hook+jump replaced by its label-propagation variant), SSSP is round-based
Bellman-Ford with atomic relaxations rather than delta-stepping.
"""

COMMON = r"""
# ============ GAPBS common harness ============
.bss
.align 3
g_n: .zero 8
g_m: .zero 8
g_rowptr: .zero 8
g_colidx: .zero 8
g_weights: .zero 8
g_nthreads: .zero 8
g_ntrials: .zero 8
g_quit: .zero 8
g_trial: .zero 8
g_src: .zero 8
start_barrier: .zero 24
end_barrier: .zero 24
g_tcbs: .zero 64          # up to 8 worker handles

.text
# chunk(a0=tid) -> a0=start, a1=end  (node range for this thread)
chunk:
    la t0, g_n
    ld t1, 0(t0)           # n
    la t0, g_nthreads
    ld t2, 0(t0)           # T
    add t3, t1, t2
    addi t3, t3, -1
    divu t3, t3, t2        # ceil(n/T)
    mul a1, a0, t3
    add t4, a1, t3
    bltu t4, t1, 1f
    mv t4, t1
1:
    mv a0, a1
    mv a1, t4
    ret

# worker(a0 = tid)
worker:
    addi sp, sp, -32
    sd ra, 24(sp)
    sd s0, 16(sp)
    mv s0, a0
1:
    la a0, start_barrier
    call barrier_wait
    la t0, g_quit
    ld t1, 0(t0)
    bnez t1, 2f
    mv a0, s0
    call bench_kernel
    la a0, end_barrier
    call barrier_wait
    j 1b
2:
    ld s0, 16(sp)
    ld ra, 24(sp)
    addi sp, sp, 32
    li a0, 0
    ret

# load_graph(a0 = path)
load_graph:
    addi sp, sp, -64
    sd ra, 56(sp)
    sd s0, 48(sp)
    sd s1, 40(sp)
    sd s2, 32(sp)
    li t0, -100            # AT_FDCWD
    mv a1, a0
    mv a0, t0
    li a2, 0               # O_RDONLY
    li a3, 0
    call openat4
    mv s0, a0              # fd
    mv a0, s0
    mv a1, sp              # stat buf (on stack, 64B enough for size@48)
    addi sp, sp, -128
    mv a1, sp
    call fstat
    ld s1, 48(sp)          # st_size
    addi sp, sp, 128
    mv a0, s1
    call malloc
    mv s2, a0              # buffer
    # read loop
    mv t0, s2
    mv t1, s1
1:
    beqz t1, 2f
    mv a0, s0
    mv a1, t0
    mv a2, t1
    addi sp, sp, -32
    sd t0, 0(sp)
    sd t1, 8(sp)
    call read
    ld t0, 0(sp)
    ld t1, 8(sp)
    addi sp, sp, 32
    blez a0, 2f
    add t0, t0, a0
    sub t1, t1, a0
    j 1b
2:
    mv a0, s0
    call close
    # parse header
    ld t0, 0(s2)           # n
    la t1, g_n
    sd t0, 0(t1)
    ld t2, 8(s2)           # m
    la t1, g_m
    sd t2, 0(t1)
    ld t3, 16(s2)          # has_weights
    addi t4, s2, 24        # rowptr
    la t1, g_rowptr
    sd t4, 0(t1)
    addi t5, t0, 1
    slli t5, t5, 3
    add t4, t4, t5         # colidx
    la t1, g_colidx
    sd t4, 0(t1)
    beqz t3, 3f
    slli t5, t2, 3
    add t4, t4, t5
    la t1, g_weights
    sd t4, 0(t1)
3:
    ld s2, 32(sp)
    ld s1, 40(sp)
    ld s0, 48(sp)
    ld ra, 56(sp)
    addi sp, sp, 64
    ret

# main(argc, argv)
main:
    addi sp, sp, -64
    sd ra, 56(sp)
    sd s0, 48(sp)
    sd s1, 40(sp)
    sd s2, 32(sp)
    mv s0, a1              # argv
    ld a0, 8(s0)           # argv[1] graph file
    call load_graph
    ld a0, 16(s0)          # argv[2] threads
    call atoi
    la t0, g_nthreads
    sd a0, 0(t0)
    ld a0, 24(s0)          # argv[3] trials
    call atoi
    la t0, g_ntrials
    sd a0, 0(t0)
    # barriers
    la a0, start_barrier
    la t0, g_nthreads
    ld a1, 0(t0)
    call barrier_init
    la a0, end_barrier
    la t0, g_nthreads
    ld a1, 0(t0)
    call barrier_init
    call bench_init
    # spawn workers 1..T-1
    la t0, g_nthreads
    ld s1, 0(t0)
    li s2, 1
1:
    bgeu s2, s1, 2f
    la a0, worker
    mv a1, s2
    call thread_spawn
    la t0, g_tcbs
    slli t1, s2, 3
    add t0, t0, t1
    sd a0, 0(t0)
    addi s2, s2, 1
    j 1b
2:
    # trials
    li s2, 0
3:
    la t0, g_ntrials
    ld t1, 0(t0)
    bgeu s2, t1, 6f
    la t0, g_trial
    sd s2, 0(t0)
    mv a0, s2
    call bench_trial_begin
    call clock_ns
    mv s1, a0
    la a0, start_barrier
    call barrier_wait
    li a0, 0
    call bench_kernel
    la a0, end_barrier
    call barrier_wait
    call clock_ns
    sub s1, a0, s1
    mv a0, s2
    call bench_trial_end
    la a0, .Ltrialmsg
    mv a1, s1
    call print_kv
    addi s2, s2, 1
    j 3b
6:
    # shut down workers
    la t0, g_quit
    li t1, 1
    sd t1, 0(t0)
    la a0, start_barrier
    call barrier_wait
    la t0, g_nthreads
    ld s1, 0(t0)
    li s2, 1
7:
    bgeu s2, s1, 8f
    la t0, g_tcbs
    slli t1, s2, 3
    add t0, t0, t1
    ld a0, 0(t0)
    call thread_join
    addi s2, s2, 1
    j 7b
8:
    call bench_report
    li a0, 0
    ld s2, 32(sp)
    ld s1, 40(sp)
    ld s0, 48(sp)
    ld ra, 56(sp)
    addi sp, sp, 64
    ret

.data
.Ltrialmsg: .asciz "trial_ns"
"""

PR = r"""
# ============ PageRank (pull, Q32.32 fixed point, 10 iterations) ============
.equ PR_ITERS, 10
.bss
.align 3
pr_score: .zero 8
pr_next: .zero 8
pr_contrib: .zero 8
.text
bench_init:
    addi sp, sp, -16
    sd ra, 8(sp)
    la t0, g_n
    ld a0, 0(t0)
    slli a0, a0, 3
    call malloc
    la t0, pr_score
    sd a0, 0(t0)
    la t0, g_n
    ld a0, 0(t0)
    slli a0, a0, 3
    call malloc
    la t0, pr_next
    sd a0, 0(t0)
    la t0, g_n
    ld a0, 0(t0)
    slli a0, a0, 3
    call malloc
    la t0, pr_contrib
    sd a0, 0(t0)
    ld ra, 8(sp)
    addi sp, sp, 16
    ret

bench_trial_begin:
    ret
bench_trial_end:
    ret

# kernel(tid): init scores; PR_ITERS x { contrib phase ; gather phase }
bench_kernel:
    addi sp, sp, -80
    sd ra, 72(sp)
    sd s0, 64(sp)
    sd s1, 56(sp)
    sd s2, 48(sp)
    sd s3, 40(sp)
    sd s4, 32(sp)
    sd s5, 24(sp)
    sd s6, 16(sp)
    mv s0, a0              # tid
    call chunk
    mv s1, a0              # lo
    mv s2, a1              # hi
    # init: score[v] = (1<<32)/n
    la t0, g_n
    ld t1, 0(t0)
    li t2, 1
    slli t2, t2, 32
    divu s3, t2, t1        # per-node initial score
    la t0, pr_score
    ld t4, 0(t0)
    mv t5, s1
1:
    bgeu t5, s2, 2f
    slli t6, t5, 3
    add t6, t4, t6
    sd s3, 0(t6)
    addi t5, t5, 1
    j 1b
2:
    li s6, PR_ITERS
.Liter:
    la a0, end_barrier
    call barrier_wait      # sync after init / previous iter
    # phase A: contrib[v] = score[v] / deg(v)
    la t0, pr_score
    ld t1, 0(t0)
    la t0, pr_contrib
    ld t2, 0(t0)
    la t0, g_rowptr
    ld t3, 0(t0)
    mv t5, s1
3:
    bgeu t5, s2, 4f
    slli t6, t5, 3
    add a2, t3, t6
    ld a3, 0(a2)
    ld a4, 8(a2)
    sub a4, a4, a3         # deg
    add a5, t1, t6
    ld a6, 0(a5)
    beqz a4, .Lprdeg
    divu a6, a6, a4
.Lprdeg:
    add a5, t2, t6
    sd a6, 0(a5)
    addi t5, t5, 1
    j 3b
4:
    la a0, start_barrier
    call barrier_wait
    # phase B: next[v] = base + 0.85 * sum contrib[u]
    la t0, g_n
    ld t1, 0(t0)
    li t2, 643371375       # 0.15 * 2^32
    divu s4, t2, t1        # base
    la t0, g_rowptr
    ld t3, 0(t0)
    la t0, g_colidx
    ld a7, 0(t0)
    la t0, pr_contrib
    ld t2, 0(t0)
    la t0, pr_score
    ld s5, 0(t0)
    mv t5, s1
5:
    bgeu t5, s2, 7f
    slli t6, t5, 3
    add a2, t3, t6
    ld a3, 0(a2)           # row start
    ld a4, 8(a2)           # row end
    li a5, 0               # acc
6:
    bgeu a3, a4, .Lprnx
    slli a6, a3, 3
    add a6, a7, a6
    ld a6, 0(a6)           # neighbor u
    slli a6, a6, 3
    add a6, t2, a6
    ld a6, 0(a6)           # contrib[u]
    add a5, a5, a6
    addi a3, a3, 1
    j 6b
.Lprnx:
    # next = base + (acc * 3482) >> 12   (~0.85)
    li a6, 3482
    mul a5, a5, a6
    srli a5, a5, 12
    add a5, a5, s4
    add a6, s5, t6
    sd a5, 0(a6)           # write into score (safe: pull uses contrib)
    addi t5, t5, 1
    j 5b
7:
    addi s6, s6, -1
    beqz s6, 8f
    j .Liter
8:
    ld s6, 16(sp)
    ld s5, 24(sp)
    ld s4, 32(sp)
    ld s3, 40(sp)
    ld s2, 48(sp)
    ld s1, 56(sp)
    ld s0, 64(sp)
    ld ra, 72(sp)
    addi sp, sp, 80
    ret

bench_report:
    addi sp, sp, -16
    sd ra, 8(sp)
    la t0, pr_score
    ld t1, 0(t0)
    ld a1, 0(t1)           # score[0] as checksum
    la a0, .Lprmsg
    call print_kv
    ld ra, 8(sp)
    addi sp, sp, 16
    ret
.data
.Lprmsg: .asciz "pr_score0"
"""

BFS = r"""
# ============ BFS (top-down, atomic frontier queue) ============
.bss
.align 3
bfs_parent: .zero 8
bfs_cur: .zero 8
bfs_next: .zero 8
bfs_cur_size: .zero 8
bfs_next_tail: .zero 8
bfs_fetch: .zero 8
bfs_reached: .zero 8
.text
bench_init:
    addi sp, sp, -16
    sd ra, 8(sp)
    la t0, g_n
    ld a0, 0(t0)
    slli a0, a0, 3
    call malloc
    la t0, bfs_parent
    sd a0, 0(t0)
    la t0, g_n
    ld a0, 0(t0)
    slli a0, a0, 3
    call malloc
    la t0, bfs_cur
    sd a0, 0(t0)
    la t0, g_n
    ld a0, 0(t0)
    slli a0, a0, 3
    call malloc
    la t0, bfs_next
    sd a0, 0(t0)
    ret_init:
    ld ra, 8(sp)
    addi sp, sp, 16
    ret

# trial setup (main thread only): reset parent, seed frontier with src
bench_trial_begin:
    addi sp, sp, -32
    sd ra, 24(sp)
    sd s0, 16(sp)
    la t0, bfs_parent
    ld t1, 0(t0)
    la t0, g_n
    ld t2, 0(t0)
    li t3, -1
    mv t4, t1
    mv t5, t2
1:
    beqz t5, 2f
    sd t3, 0(t4)
    addi t4, t4, 8
    addi t5, t5, -1
    j 1b
2:
    # src = trial % n
    la t0, g_trial
    ld t3, 0(t0)
    remu t3, t3, t2
    la t0, g_src
    sd t3, 0(t0)
    slli t4, t3, 3
    add t4, t1, t4
    sd t3, 0(t4)           # parent[src] = src
    la t0, bfs_cur
    ld t1, 0(t0)
    sd t3, 0(t1)
    la t0, bfs_cur_size
    li t1, 1
    sd t1, 0(t0)
    la t0, bfs_next_tail
    sd zero, 0(t0)
    la t0, bfs_fetch
    sd zero, 0(t0)
    la t0, bfs_reached
    li t1, 1
    sd t1, 0(t0)
    ld s0, 16(sp)
    ld ra, 24(sp)
    addi sp, sp, 32
    ret
bench_trial_end:
    ret

# kernel(tid): level-synchronous; work grabbed in batches of 8 via amoadd
bench_kernel:
    addi sp, sp, -96
    sd ra, 88(sp)
    sd s0, 80(sp)
    sd s1, 72(sp)
    sd s2, 64(sp)
    sd s3, 56(sp)
    sd s4, 48(sp)
    sd s5, 40(sp)
    sd s6, 32(sp)
    sd s7, 24(sp)
    sd s8, 16(sp)
    mv s0, a0              # tid
.Llevel:
    la t0, bfs_cur_size
    ld s1, 0(t0)           # frontier size
    beqz s1, .Ldone
    la t0, bfs_cur
    ld s2, 0(t0)
    la t0, bfs_next
    ld s3, 0(t0)
    la t0, bfs_parent
    ld s4, 0(t0)
    la t0, g_rowptr
    ld s5, 0(t0)
    la t0, g_colidx
    ld s6, 0(t0)
.Lgrab:
    li t0, 8
    la t1, bfs_fetch
    amoadd.d s7, t0, (t1)  # batch start
    bgeu s7, s1, .Llevel_end
    addi s8, s7, 8
    bleu s8, s1, 1f
    mv s8, s1
1:
    # process frontier[s7..s8)
2:
    bgeu s7, s8, .Lgrab
    slli t0, s7, 3
    add t0, s2, t0
    ld a2, 0(t0)           # u
    slli t1, a2, 3
    add t1, s5, t1
    ld a3, 0(t1)           # row lo
    ld a4, 8(t1)           # row hi
3:
    bgeu a3, a4, 5f
    slli t2, a3, 3
    add t2, s6, t2
    ld a5, 0(t2)           # v
    slli t3, a5, 3
    add t3, s4, t3         # &parent[v]
    ld t4, 0(t3)
    li t5, -1
    bne t4, t5, 4f
    # CAS parent[v]: -1 -> u
    mv a6, a2
cas1:
    lr.d t4, (t3)
    bne t4, t5, 4f
    sc.d t6, a6, (t3)
    bnez t6, cas1
    # enqueue v
    li t6, 1
    la a7, bfs_next_tail
    amoadd.d t4, t6, (a7)
    slli t4, t4, 3
    add t4, s3, t4
    sd a5, 0(t4)
4:
    addi a3, a3, 1
    j 3b
5:
    addi s7, s7, 1
    j 2b
.Llevel_end:
    la a0, end_barrier
    call barrier_wait
    # thread 0 swaps frontier
    bnez s0, 1f
    la t0, bfs_cur
    la t1, bfs_next
    ld t2, 0(t0)
    ld t3, 0(t1)
    sd t3, 0(t0)
    sd t2, 0(t1)
    la t0, bfs_next_tail
    ld t2, 0(t0)
    la t1, bfs_cur_size
    sd t2, 0(t1)
    sd zero, 0(t0)
    la t0, bfs_fetch
    sd zero, 0(t0)
    la t0, bfs_reached
    ld t1, 0(t0)
    add t1, t1, t2
    sd t1, 0(t0)
1:
    la a0, start_barrier
    call barrier_wait
    j .Llevel
.Ldone:
    ld s8, 16(sp)
    ld s7, 24(sp)
    ld s6, 32(sp)
    ld s5, 40(sp)
    ld s4, 48(sp)
    ld s3, 56(sp)
    ld s2, 64(sp)
    ld s1, 72(sp)
    ld s0, 80(sp)
    ld ra, 88(sp)
    addi sp, sp, 96
    ret

bench_report:
    addi sp, sp, -16
    sd ra, 8(sp)
    la t0, bfs_reached
    ld a1, 0(t0)
    la a0, .Lbfsmsg
    call print_kv
    ld ra, 8(sp)
    addi sp, sp, 16
    ret
.data
.Lbfsmsg: .asciz "bfs_reached"
"""

CC = r"""
# ============ Connected Components (min-label propagation, amomin) ========
.bss
.align 3
cc_comp: .zero 8
cc_changed: .zero 8
.text
bench_init:
    addi sp, sp, -16
    sd ra, 8(sp)
    la t0, g_n
    ld a0, 0(t0)
    slli a0, a0, 3
    call malloc
    la t0, cc_comp
    sd a0, 0(t0)
    ld ra, 8(sp)
    addi sp, sp, 16
    ret
bench_trial_begin:
    ret
bench_trial_end:
    ret

bench_kernel:
    addi sp, sp, -80
    sd ra, 72(sp)
    sd s0, 64(sp)
    sd s1, 56(sp)
    sd s2, 48(sp)
    sd s3, 40(sp)
    sd s4, 32(sp)
    sd s5, 24(sp)
    mv s0, a0
    call chunk
    mv s1, a0
    mv s2, a1
    la t0, cc_comp
    ld s3, 0(t0)
    # init comp[v] = v
    mv t5, s1
1:
    bgeu t5, s2, 2f
    slli t6, t5, 3
    add t6, s3, t6
    sd t5, 0(t6)
    addi t5, t5, 1
    j 1b
2:
    la t0, g_rowptr
    ld s4, 0(t0)
    la t0, g_colidx
    ld s5, 0(t0)
.Lround:
    # reset changed (thread 0), all wait
    la a0, end_barrier
    call barrier_wait
    bnez s0, 3f
    la t0, cc_changed
    sd zero, 0(t0)
3:
    la a0, start_barrier
    call barrier_wait
    # propagate: comp[v] = min(comp[v], min over nbrs comp[u])
    mv t5, s1
4:
    bgeu t5, s2, 7f
    slli t6, t5, 3
    add a2, s4, t6
    ld a3, 0(a2)
    ld a4, 8(a2)
    add a5, s3, t6         # &comp[v]
    ld a6, 0(a5)           # comp[v]
5:
    bgeu a3, a4, 6f
    slli t2, a3, 3
    add t2, s5, t2
    ld t3, 0(t2)           # u
    slli t3, t3, 3
    add t3, s3, t3
    ld t4, 0(t3)           # comp[u]
    bgeu t4, a6, .Lccskip
    # smaller label found: amomin into comp[v], flag change
    amomin.d t4, t4, (a5)
    ld a6, 0(a5)
    la t2, cc_changed
    li t3, 1
    sd t3, 0(t2)
.Lccskip:
    addi a3, a3, 1
    j 5b
6:
    addi t5, t5, 1
    j 4b
7:
    la a0, end_barrier
    call barrier_wait
    la t0, cc_changed
    ld t1, 0(t0)
    la a0, start_barrier
    addi sp, sp, -16
    sd t1, 0(sp)
    call barrier_wait
    ld t1, 0(sp)
    addi sp, sp, 16
    bnez t1, .Lround
    ld s5, 24(sp)
    ld s4, 32(sp)
    ld s3, 40(sp)
    ld s2, 48(sp)
    ld s1, 56(sp)
    ld s0, 64(sp)
    ld ra, 72(sp)
    addi sp, sp, 80
    ret

bench_report:
    addi sp, sp, -16
    sd ra, 8(sp)
    la t0, cc_comp
    ld t1, 0(t0)
    ld a1, 0(t1)
    la a0, .Lccmsg
    call print_kv
    ld ra, 8(sp)
    addi sp, sp, 16
    ret
.data
.Lccmsg: .asciz "cc_comp0"
"""

SSSP = r"""
# ============ SSSP (round-based Bellman-Ford, per-round timing) ============
.bss
.align 3
ss_dist: .zero 8
ss_changed: .zero 8
ss_round_ns: .zero 8
.text
bench_init:
    addi sp, sp, -16
    sd ra, 8(sp)
    la t0, g_n
    ld a0, 0(t0)
    slli a0, a0, 3
    call malloc
    la t0, ss_dist
    sd a0, 0(t0)
    ld ra, 8(sp)
    addi sp, sp, 16
    ret
bench_trial_begin:
    addi sp, sp, -16
    sd ra, 8(sp)
    # dist = INF; dist[src] = 0 ; src = trial % n
    la t0, ss_dist
    ld t1, 0(t0)
    la t0, g_n
    ld t2, 0(t0)
    li t3, -1
    mv t4, t1
    mv t5, t2
1:
    beqz t5, 2f
    sd t3, 0(t4)
    addi t4, t4, 8
    addi t5, t5, -1
    j 1b
2:
    la t0, g_trial
    ld t3, 0(t0)
    remu t3, t3, t2
    la t0, g_src
    sd t3, 0(t0)
    slli t3, t3, 3
    add t3, t1, t3
    sd zero, 0(t3)
    ld ra, 8(sp)
    addi sp, sp, 16
    ret
bench_trial_end:
    ret

bench_kernel:
    addi sp, sp, -96
    sd ra, 88(sp)
    sd s0, 80(sp)
    sd s1, 72(sp)
    sd s2, 64(sp)
    sd s3, 56(sp)
    sd s4, 48(sp)
    sd s5, 40(sp)
    sd s6, 32(sp)
    sd s7, 24(sp)
    mv s0, a0
    call chunk
    mv s1, a0
    mv s2, a1
    la t0, ss_dist
    ld s3, 0(t0)
    la t0, g_rowptr
    ld s4, 0(t0)
    la t0, g_colidx
    ld s5, 0(t0)
    la t0, g_weights
    ld s6, 0(t0)
.Lround:
    la a0, end_barrier
    call barrier_wait
    bnez s0, 1f
    la t0, ss_changed
    sd zero, 0(t0)
1:
    la a0, start_barrier
    call barrier_wait
    # GAPBS-style fine-grained timing: every thread stamps every round
    call clock_ns
    la t0, ss_round_ns
    sd a0, 0(t0)
    # relax all edges of my nodes
    mv t5, s1
2:
    bgeu t5, s2, 5f
    slli t6, t5, 3
    add a2, s3, t6
    ld a3, 0(a2)           # du
    li t0, -1
    beq a3, t0, 4f
    add a2, s4, t6
    ld a4, 0(a2)
    ld a5, 8(a2)
3:
    bgeu a4, a5, 4f
    slli t1, a4, 3
    add t2, s5, t1
    ld a6, 0(t2)           # v
    add t2, s6, t1
    ld a7, 0(t2)           # w
    add a7, a7, a3         # nd
    slli t3, a6, 3
    add t3, s3, t3
    ld t4, 0(t3)
    bgeu a7, t4, .Lssskip
    amominu.d t4, a7, (t3)
    la t2, ss_changed
    li t3, 1
    sd t3, 0(t2)
.Lssskip:
    addi a4, a4, 1
    j 3b
4:
    addi t5, t5, 1
    j 2b
5:
    # per-round timing close
    call clock_ns
    la a0, end_barrier
    call barrier_wait
    la t0, ss_changed
    ld s7, 0(t0)
    la a0, start_barrier
    call barrier_wait
    bnez s7, .Lround
    ld s7, 24(sp)
    ld s6, 32(sp)
    ld s5, 40(sp)
    ld s4, 48(sp)
    ld s3, 56(sp)
    ld s2, 64(sp)
    ld s1, 72(sp)
    ld s0, 80(sp)
    ld ra, 88(sp)
    addi sp, sp, 96
    ret

bench_report:
    addi sp, sp, -16
    sd ra, 8(sp)
    la t0, ss_dist
    ld t1, 0(t0)
    ld a1, 8(t1)           # dist[1]
    la a0, .Lssmsg
    call print_kv
    ld ra, 8(sp)
    addi sp, sp, 16
    ret
.data
.Lssmsg: .asciz "sssp_dist1"
"""

BC = r"""
# ====== Betweenness Centrality (single source per trial, Q32.32 deltas) ====
.bss
.align 3
bc_level: .zero 8
bc_sigma: .zero 8
bc_delta: .zero 8
bc_queue: .zero 8
bc_qstarts: .zero 8
bc_qtail: .zero 8
bc_fetch: .zero 8
bc_lev: .zero 8
bc_qlo: .zero 8
bc_qhi: .zero 8
.text
bench_init:
    addi sp, sp, -16
    sd ra, 8(sp)
    la t0, g_n
    ld a0, 0(t0)
    slli a0, a0, 3
    call malloc
    la t0, bc_level
    sd a0, 0(t0)
    la t0, g_n
    ld a0, 0(t0)
    slli a0, a0, 3
    call malloc
    la t0, bc_sigma
    sd a0, 0(t0)
    la t0, g_n
    ld a0, 0(t0)
    slli a0, a0, 3
    call malloc
    la t0, bc_delta
    sd a0, 0(t0)
    la t0, g_n
    ld a0, 0(t0)
    slli a0, a0, 3
    call malloc
    la t0, bc_queue
    sd a0, 0(t0)
    li a0, 1024            # level boundaries
    call malloc
    la t0, bc_qstarts
    sd a0, 0(t0)
    ld ra, 8(sp)
    addi sp, sp, 16
    ret

bench_trial_begin:
    addi sp, sp, -16
    sd ra, 8(sp)
    la t0, bc_level
    ld t1, 0(t0)
    la t0, bc_sigma
    ld t2, 0(t0)
    la t0, bc_delta
    ld t3, 0(t0)
    la t0, g_n
    ld t4, 0(t0)
    li t5, -1
1:
    beqz t4, 2f
    sd t5, 0(t1)
    sd zero, 0(t2)
    sd zero, 0(t3)
    addi t1, t1, 8
    addi t2, t2, 8
    addi t3, t3, 8
    addi t4, t4, -1
    j 1b
2:
    # src = trial % n ; level[src]=0 sigma[src]=1 queue[0]=src
    la t0, g_trial
    ld t3, 0(t0)
    la t0, g_n
    ld t2, 0(t0)
    remu t3, t3, t2
    la t0, g_src
    sd t3, 0(t0)
    la t0, bc_level
    ld t1, 0(t0)
    slli t4, t3, 3
    add t4, t1, t4
    sd zero, 0(t4)
    la t0, bc_sigma
    ld t1, 0(t0)
    slli t4, t3, 3
    add t4, t1, t4
    li t5, 1
    sd t5, 0(t4)
    la t0, bc_queue
    ld t1, 0(t0)
    sd t3, 0(t1)
    la t0, bc_qtail
    li t5, 1
    sd t5, 0(t0)
    la t0, bc_qstarts
    ld t1, 0(t0)
    sd zero, 0(t1)         # qstarts[0] = 0
    li t5, 1
    sd t5, 8(t1)           # qstarts[1] = 1
    la t0, bc_lev
    sd zero, 0(t0)
    la t0, bc_qlo
    sd zero, 0(t0)
    la t0, bc_qhi
    li t5, 1
    sd t5, 0(t0)
    la t0, bc_fetch
    sd zero, 0(t0)
    ld ra, 8(sp)
    addi sp, sp, 16
    ret
bench_trial_end:
    ret

bench_kernel:
    addi sp, sp, -112
    sd ra, 104(sp)
    sd s0, 96(sp)
    sd s1, 88(sp)
    sd s2, 80(sp)
    sd s3, 72(sp)
    sd s4, 64(sp)
    sd s5, 56(sp)
    sd s6, 48(sp)
    sd s7, 40(sp)
    sd s8, 32(sp)
    sd s9, 24(sp)
    mv s0, a0
    la t0, bc_level
    ld s3, 0(t0)
    la t0, bc_sigma
    ld s4, 0(t0)
    la t0, g_rowptr
    ld s5, 0(t0)
    la t0, g_colidx
    ld s6, 0(t0)
    la t0, bc_queue
    ld s9, 0(t0)
# ---------- forward phase: level-synchronous with shared queue ----------
.Lfwd:
    la t0, bc_qlo
    ld s1, 0(t0)
    la t0, bc_qhi
    ld s2, 0(t0)
    bgeu s1, s2, .Lfwd_done
    la t0, bc_lev
    ld s7, 0(t0)           # current level
.Lfgrab:
    li t0, 4
    la t1, bc_fetch
    amoadd.d s8, t0, (t1)
    add s8, s8, s1         # absolute index
    bgeu s8, s2, .Lflevel_end
    addi t0, s8, 4
    bleu t0, s2, 1f
    mv t0, s2
1:
    mv a7, t0              # batch end
2:
    bgeu s8, a7, .Lfgrab
    slli t0, s8, 3
    add t0, s9, t0
    ld a2, 0(t0)           # u
    slli t1, a2, 3
    add t2, s5, t1
    ld a3, 0(t2)
    ld a4, 8(t2)
    add t2, s4, t1
    ld a6, 0(t2)           # sigma[u]
3:
    bgeu a3, a4, 6f
    slli t2, a3, 3
    add t2, s6, t2
    ld a5, 0(t2)           # v
    slli t3, a5, 3
    add t4, s3, t3         # &level[v]
    ld t5, 0(t4)
    li t6, -1
    addi t2, s7, 1         # lev+1
    beq t5, t2, 5f         # already next level: add sigma
    bne t5, t6, .Lbcskip   # visited earlier level: skip
# CAS level[v]: -1 -> lev+1
cas2:
    lr.d t5, (t4)
    bne t5, t6, 4f
    sc.d a1, t2, (t4)
    bnez a1, cas2
    # enqueue
    li a1, 1
    la t5, bc_qtail
    amoadd.d a0, a1, (t5)
    slli a0, a0, 3
    add a0, s9, a0
    sd a5, 0(a0)
    j 5f
4:
    bne t5, t2, .Lbcskip   # someone else claimed; same level -> add sigma
5:
    add t3, s4, t3
    amoadd.d zero, a6, (t3)   # sigma[v] += sigma[u]
.Lbcskip:
    addi a3, a3, 1
    j 3b
6:
    addi s8, s8, 1
    j 2b
.Lflevel_end:
    la a0, end_barrier
    call barrier_wait
    bnez s0, 1f
    # thread 0: close level
    la t0, bc_lev
    ld t1, 0(t0)
    addi t1, t1, 1
    sd t1, 0(t0)
    la t0, bc_qhi
    ld t2, 0(t0)
    la t0, bc_qlo
    sd t2, 0(t0)
    la t0, bc_qtail
    ld t3, 0(t0)
    la t0, bc_qhi
    sd t3, 0(t0)
    la t0, bc_qstarts
    ld t4, 0(t0)
    addi t5, t1, 1
    slli t5, t5, 3
    add t4, t4, t5
    sd t3, 0(t4)           # qstarts[lev+1] = qtail
    la t0, bc_fetch
    sd zero, 0(t0)
1:
    la a0, start_barrier
    call barrier_wait
    j .Lfwd
.Lfwd_done:
# ---------- backward phase: levels from deepest-1 down to 0 ----------
    la a0, end_barrier
    call barrier_wait
    la t0, bc_lev
    ld s7, 0(t0)           # number of levels (deepest empty)
    addi s7, s7, -2        # start at deepest non-empty - 1
.Lbwd:
    bltz s7, .Lbwd_done
    la a0, start_barrier
    call barrier_wait
    # process queue[qstarts[s7] .. qstarts[s7+1]) partitioned statically
    la t0, bc_qstarts
    ld t1, 0(t0)
    slli t2, s7, 3
    add t2, t1, t2
    ld s1, 0(t2)           # lo
    ld s2, 8(t2)           # hi
    # static partition among threads
    sub t3, s2, s1
    la t0, g_nthreads
    ld t4, 0(t0)
    add t5, t3, t4
    addi t5, t5, -1
    divu t5, t5, t4        # chunk
    mul t6, s0, t5
    add t6, s1, t6         # my lo
    add a7, t6, t5
    bleu a7, s2, 1f
    mv a7, s2
1:
    la t0, bc_delta
    ld a1, 0(t0)
2:
    bgeu t6, a7, .Lbwd_sync
    slli t0, t6, 3
    add t0, s9, t0
    ld a2, 0(t0)           # u
    slli t1, a2, 3
    add t2, s5, t1
    ld a3, 0(t2)
    ld a4, 8(t2)
    add t2, s4, t1
    ld a6, 0(t2)           # sigma[u]
    li a5, 0               # acc (Q32.32)
3:
    bgeu a3, a4, 5f
    slli t2, a3, 3
    add t2, s6, t2
    ld t3, 0(t2)           # v
    slli t4, t3, 3
    add t5, s3, t4
    ld t5, 0(t5)           # level[v]
    addi t0, s7, 1
    bne t5, t0, 4f
    # acc += sigma[u] * (ONE + delta[v]) / sigma[v]
    add t5, a1, t4
    ld t5, 0(t5)           # delta[v]
    li t0, 1
    slli t0, t0, 32
    add t5, t5, t0         # ONE + delta (Q32)
    mul t5, t5, a6         # sigma[u] * (...)   (sigma small)
    add t2, s4, t4
    ld t2, 0(t2)           # sigma[v]
    divu t5, t5, t2
    add a5, a5, t5
4:
    addi a3, a3, 1
    j 3b
5:
    slli t0, a2, 3
    add t0, a1, t0
    sd a5, 0(t0)           # delta[u] = acc (u owned by this thread)
    addi t6, t6, 1
    j 2b
.Lbwd_sync:
    la a0, end_barrier
    call barrier_wait
    addi s7, s7, -1
    j .Lbwd
.Lbwd_done:
    ld s9, 24(sp)
    ld s8, 32(sp)
    ld s7, 40(sp)
    ld s6, 48(sp)
    ld s5, 56(sp)
    ld s4, 64(sp)
    ld s3, 72(sp)
    ld s2, 80(sp)
    ld s1, 88(sp)
    ld s0, 96(sp)
    ld ra, 104(sp)
    addi sp, sp, 112
    ret

bench_report:
    addi sp, sp, -16
    sd ra, 8(sp)
    la t0, bc_delta
    ld t1, 0(t0)
    la t0, g_src
    ld t2, 0(t0)
    ld a1, 0(t1)
    la a0, .Lbcmsg
    call print_kv
    ld ra, 8(sp)
    addi sp, sp, 16
    ret
.data
.Lbcmsg: .asciz "bc_delta0"
"""

TC = r"""
# == Triangle Counting (sorted merge-intersection; per-trial mmap churn) ====
.bss
.align 3
tc_count: .zero 8
tc_ws: .zero 8
tc_fetch: .zero 8
.text
bench_init:
    ret

# per-trial: allocate a big workspace (mmap), copy colidx into it, touch all
# pages — reproduces the paper's TC pathology (§VI-C3): repeated large
# allocations with lazy-init page-fault storms every iteration.
bench_trial_begin:
    addi sp, sp, -32
    sd ra, 24(sp)
    sd s0, 16(sp)
    la t0, g_m
    ld a0, 0(t0)
    slli a0, a0, 3
    li t1, 1048576
    add a0, a0, t1         # graph copy + 1MB scratch
    call malloc            # large -> mmap path
    la t0, tc_ws
    sd a0, 0(t0)
    mv s0, a0
    la t0, g_colidx
    ld a1, 0(t0)
    la t0, g_m
    ld a2, 0(t0)
    slli a2, a2, 3
    mv a0, s0
    call memcpy            # faults in the workspace page by page
    la t0, tc_count
    sd zero, 0(t0)
    la t0, tc_fetch
    sd zero, 0(t0)
    ld s0, 16(sp)
    ld ra, 24(sp)
    addi sp, sp, 32
    ret

bench_trial_end:
    addi sp, sp, -16
    sd ra, 8(sp)
    la t0, tc_ws
    ld a0, 0(t0)
    call free              # munmap: page-table teardown every trial
    ld ra, 8(sp)
    addi sp, sp, 16
    ret

# kernel(tid): count ordered triangles u < v < w, dynamic node batches
bench_kernel:
    addi sp, sp, -96
    sd ra, 88(sp)
    sd s0, 80(sp)
    sd s1, 72(sp)
    sd s2, 64(sp)
    sd s3, 56(sp)
    sd s4, 48(sp)
    sd s5, 40(sp)
    sd s6, 32(sp)
    sd s7, 24(sp)
    mv s0, a0
    la t0, g_n
    ld s1, 0(t0)
    la t0, g_rowptr
    ld s2, 0(t0)
    la t0, tc_ws
    ld s3, 0(t0)           # adjacency copy in workspace
    li s7, 0               # local count
.Lgrab:
    li t0, 4
    la t1, tc_fetch
    amoadd.d s4, t0, (t1)
    bgeu s4, s1, .Ltcdone
    addi s5, s4, 4
    bleu s5, s1, 1f
    mv s5, s1
1:
2:
    bgeu s4, s5, .Lgrab
    mv a2, s4              # u
    slli t0, a2, 3
    add t0, s2, t0
    ld a3, 0(t0)           # u row lo
    ld a4, 8(t0)           # u row hi
3:
    bgeu a3, a4, 9f
    slli t0, a3, 3
    add t0, s3, t0
    ld a5, 0(t0)           # v
    bleu a5, a2, 8f        # need v > u
    # intersect adj(u)[a3+1..a4) with adj(v) where w > v
    slli t0, a5, 3
    add t0, s2, t0
    ld a6, 0(t0)           # v row lo
    ld a7, 8(t0)           # v row hi
    addi t1, a3, 1         # u ptr
4:
    bgeu t1, a4, 8f
    bgeu a6, a7, 8f
    slli t2, t1, 3
    add t2, s3, t2
    ld t3, 0(t2)           # w1 from adj(u)
    slli t4, a6, 3
    add t4, s3, t4
    ld t5, 0(t4)           # w2 from adj(v)
    bleu t5, a5, 6f        # w2 must be > v
    bltu t3, t5, 5f
    bgtu t3, t5, 6f
    # equal and > v: triangle
    addi s7, s7, 1
    addi t1, t1, 1
    addi a6, a6, 1
    j 4b
5:
    addi t1, t1, 1
    j 4b
6:
    addi a6, a6, 1
    j 4b
8:
    addi a3, a3, 1
    j 3b
9:
    addi s4, s4, 1
    j 2b
.Ltcdone:
    la t0, tc_count
    amoadd.d zero, s7, (t0)
    ld s7, 24(sp)
    ld s6, 32(sp)
    ld s5, 40(sp)
    ld s4, 48(sp)
    ld s3, 56(sp)
    ld s2, 64(sp)
    ld s1, 72(sp)
    ld s0, 80(sp)
    ld ra, 88(sp)
    addi sp, sp, 96
    ret

bench_report:
    addi sp, sp, -16
    sd ra, 8(sp)
    la t0, tc_count
    ld a1, 0(t0)
    la a0, .Ltcmsg
    call print_kv
    ld ra, 8(sp)
    addi sp, sp, 16
    ret
.data
.Ltcmsg: .asciz "tc_triangles"
"""

KERNELS = {"pr": PR, "bfs": BFS, "cc": CC, "sssp": SSSP, "bc": BC, "tc": TC}
