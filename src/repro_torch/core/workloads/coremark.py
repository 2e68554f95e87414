"""CoreMark-lite: single-thread compute benchmark in the CoreMark spirit —
a mix of linked-list find/sort surrogate (array scan + swap), 16x16 integer
matrix multiply-accumulate, and CRC-16 over a buffer, iterated N times with
a self-check, timed with ``clock_gettime`` and reported through ``write``
(the only syscalls in steady state, like real CoreMark under syscall
emulation — paper §VI-E).

Usage: prog <iterations>
"""

COREMARK = r"""
.equ MAT_N, 16
.equ BUF_LEN, 256

.bss
.align 3
cm_matA: .zero 2048         # 16x16 u64
cm_matB: .zero 2048
cm_matC: .zero 2048
cm_buf: .zero 256
cm_list: .zero 512          # 64 u64 values

.text
# crc16(a0=buf, a1=len) -> a0
cm_crc16:
    li t0, 0xFFFF
1:
    beqz a1, 4f
    lbu t1, 0(a0)
    xor t0, t0, t1
    li t2, 8
2:
    andi t3, t0, 1
    srli t0, t0, 1
    beqz t3, 3f
    li t4, 0xA001
    xor t0, t0, t4
3:
    addi t2, t2, -1
    bnez t2, 2b
    addi a0, a0, 1
    addi a1, a1, -1
    j 1b
4:
    li t5, 0xFFFF
    and a0, t0, t5
    ret

# matmul: C += A*B (16x16 u64)
cm_matmul:
    la t0, cm_matA
    la t1, cm_matB
    la t2, cm_matC
    li t3, 0               # i
1:
    li t4, 0               # j
2:
    li t5, 0               # k
    li a5, 0               # acc
3:
    slli a2, t3, 4
    add a2, a2, t5
    slli a2, a2, 3
    add a2, t0, a2
    ld a3, 0(a2)           # A[i][k]
    slli a2, t5, 4
    add a2, a2, t4
    slli a2, a2, 3
    add a2, t1, a2
    ld a4, 0(a2)           # B[k][j]
    mul a3, a3, a4
    add a5, a5, a3
    addi t5, t5, 1
    li a2, MAT_N
    blt t5, a2, 3b
    slli a2, t3, 4
    add a2, a2, t4
    slli a2, a2, 3
    add a2, t2, a2
    ld a3, 0(a2)
    add a3, a3, a5
    sd a3, 0(a2)
    addi t4, t4, 1
    li a2, MAT_N
    blt t4, a2, 2b
    addi t3, t3, 1
    li a2, MAT_N
    blt t3, a2, 1b
    ret

# list pass: selection-min scan + swap over 64 entries, 8 rounds
cm_list_sort:
    la t0, cm_list
    li t1, 0               # round
1:
    li t2, 0               # i
2:
    slli a2, t2, 3
    add a2, t0, a2
    ld a3, 0(a2)           # cur min
    mv a4, t2              # min idx
    addi t3, t2, 1
3:
    li a5, 64
    bgeu t3, a5, 4f
    slli a5, t3, 3
    add a5, t0, a5
    ld a6, 0(a5)
    bgeu a6, a3, .Lnomin
    mv a3, a6
    mv a4, t3
.Lnomin:
    addi t3, t3, 1
    j 3b
4:
    # swap list[i], list[min]
    slli a5, a4, 3
    add a5, t0, a5
    ld a6, 0(a2)
    ld a7, 0(a5)
    sd a7, 0(a2)
    sd a6, 0(a5)
    addi t2, t2, 1
    li a5, 63
    bltu t2, a5, 2b
    addi t1, t1, 1
    li a5, 2
    bltu t1, a5, 1b
    ret

main:
    addi sp, sp, -64
    sd ra, 56(sp)
    sd s0, 48(sp)
    sd s1, 40(sp)
    sd s2, 32(sp)
    sd s3, 24(sp)
    mv s0, a1
    ld a0, 8(s0)           # argv[1] = iterations
    call atoi
    mv s1, a0
    # init data deterministically
    la t0, cm_matA
    la t1, cm_matB
    li t2, 0
1:
    li t3, 256
    bgeu t2, t3, 2f
    slli t3, t2, 3
    add t4, t0, t3
    addi t5, t2, 3
    sd t5, 0(t4)
    add t4, t1, t3
    slli t5, t2, 1
    addi t5, t5, 1
    sd t5, 0(t4)
    addi t2, t2, 1
    j 1b
2:
    la t0, cm_buf
    li t2, 0
3:
    li t3, BUF_LEN
    bgeu t2, t3, 4f
    slli t4, t2, 2
    addi t4, t4, 17
    xor t4, t4, t2
    sb t4, 0(t0)
    addi t0, t0, 1
    addi t2, t2, 1
    j 3b
4:
    la t0, cm_list
    li t2, 0
5:
    li t3, 64
    bgeu t2, t3, 6f
    slli t4, t2, 3
    add t4, t0, t4
    li t5, 88172645463325252
    mul t6, t2, t5
    srli t6, t6, 3
    sd t6, 0(t4)
    addi t2, t2, 1
    j 5b
6:
    # timed loop
    call clock_ns
    mv s2, a0
    li s3, 0               # crc accumulator
7:
    beqz s1, 8f
    call cm_matmul
    call cm_list_sort
    la a0, cm_buf
    li a1, BUF_LEN
    call cm_crc16
    add s3, s3, a0
    addi s1, s1, -1
    j 7b
8:
    call clock_ns
    sub s2, a0, s2
    la a0, .Lcmtime
    mv a1, s2
    call print_kv
    la a0, .Lcmcrc
    mv a1, s3
    call print_kv
    li a0, 0
    ld s3, 24(sp)
    ld s2, 32(sp)
    ld s1, 40(sp)
    ld s0, 48(sp)
    ld ra, 56(sp)
    addi sp, sp, 64
    ret

.data
.Lcmtime: .asciz "coremark_ns"
.Lcmcrc: .asciz "coremark_crc"
"""

HELLO = r"""
main:
    addi sp, sp, -16
    sd ra, 8(sp)
    la a0, .Lhello
    call puts
    la a0, .Lkv
    li a1, 42
    call print_kv
    li a0, 0
    ld ra, 8(sp)
    addi sp, sp, 16
    ret
.data
.Lhello: .asciz "hello from FASE target\n"
.Lkv: .asciz "answer"
"""
