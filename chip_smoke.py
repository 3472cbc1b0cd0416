#!/usr/bin/env python
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

1. prints the card's name and power limit (nvidia-smi);
2. builds every instantiation of the fused-step kernel from
   engine/csrc/fused_step.cu with nvcc (sm_90a), one nvcc each, started
   together (those of steps 14, 17, 22, 26, 33, 38, 44, 49, 54, 58, 64 and 75 too): Ant's (25 plane contacts), Cartpole's contact-free one
   (-DFS_NC=0), Ingenuity's (24 plane contacts), Quadcopter's (44 plane
   contacts, two per lane, q_target input), BallBalance's (21 plane contacts,
   one point-vs-cylinder pair row, three bilateral anchors, q_target input)
   and the example model's (10 plane contacts, point-vs-box and
   point-vs-sphere pair rows); prints ptxas's register, spill and stack
   figures, the shared memory and envs per block (the choice that keeps
   the most envs resident per SM, `_cuda.envs_per_block`), the blocks and
   warps per SM the device grants each build (`fused_step_occupancy`) and
   the build seconds;
3. holds each against its plain PyTorch version on the card. Ant at
   N=RAGGED_ENVS=1003 for 3 steps (not a multiple of the kernel's envs per
   block, so the last block is part-full and its masked loads, stores and
   idle warps run) and at the main path's N=4096 for one step, random qfrc
   and xfrc. Cartpole at N=1003 for 3 steps, at N=4096 and at its training
   path's N=512 for one step, random qfrc, no xfrc; its three force outputs
   must be exactly zero. Tolerances q 2e-4, qd 2e-3, forces 2e-2;
4. drives the rollout path: the Ant VecTask at 4096 envs, a 16-step PPO
   rollout under an ActorCritic made from a seed, with the launch count
   reset just before and read just after (one launch per env step);
   checks the outputs are finite, then settles 60 zero-action steps and
   checks the summed foot contact force against the Ant's weight;
5. measures env.step throughput, profiles a few env steps (device busy
   share, top device ops), times the Ant kernel (CUDA events, median ms per
   launch) and its plain version at the main path's shapes;
6. drives the training path on Ant at full width: `load_config(["task=Ant"])`
   (4096 envs, AntPPO.yaml as it stands: horizon 16, batch 65,536,
   minibatch 32,768, 4 mini-epochs, MLP [256, 128, 64]), one warm-up epoch
   and one timed one through `PPO.train_epoch`; per epoch the launch
   count must equal the env steps, every metric be finite, the lr stay in
   [min_lr, max_lr], kl >= 0; the parameters must have moved;
7. trains Cartpole to a result through `train.main` in-process (the yaml's
   512 envs, CartpolePPO.yaml, 100 epochs, into a temporary run directory):
   the mean episode return must pass RETURN_BAR, every env step must be one
   launch of the contact-free kernel, a fresh agent must restore the last
   checkpoint bit for bit (parameters, lr, running stats, Adam moments) and
   `test=True checkpoint=...` must play past the same bar;
8. times the contact-free kernel and its plain version at N=512 and N=4096;
9. holds each new instantiation against its plain version at N=1003 for 3
   steps and at its full width for one step, with xfrc and q_target where
   the task has them, gentle inputs, in states where the rows act: a third
   of the Ingenuity and Quadcopter envs rest on the ground, BallBalance's
   ball lies on the tray (pair row active: the tray's body force must be
   non-zero), the example model's spheres press on the box and on each
   other. Tolerances as in 3 (BallBalance q 5e-4);
10. settles BallBalance at full width under zero actions with the ball on
   the tray: the three anchor points must sit within ANCHOR_TOL of their
   targets and the tray must carry about the ball's weight; settles the
   example model through `physics_step_fused` and checks that the box
   carries both spheres;
11. for Ingenuity, Quadcopter and BallBalance: one warm-up and one timed
   full-width `PPO.train_epoch`s from `load_config(["task=<name>"])`, launch
   count = horizon x control_freq_inv per epoch, finite metrics, parameters
   moved; env-steps/s and the rollout/update split printed;
12. trains BallBalance through `train.main` for BALL_EPOCHS epochs past
   BALL_RETURN_BAR (mean over the run) and BALL_LAST_EPOCH_BAR, one launch
   per env step, and plays the checkpoint;
13. times every new instantiation and its plain version at full width;
14. per-env model leaves (domain randomization) and tendons. Built in step 2
   beside the others: Ant + the five leaves its yaml randomizes, Ant + every
   leaf that has rows on it + gravity, the tendon example model alone and
   with all fifteen leaves + gravity, BallBalance + the leaves a pair row
   reads (cpoint_friction, cpoint_pos, geom_size, body_mass), and Cartpole,
   Ingenuity, Quadcopter and BallBalance + the leaves of the randomization
   block DR_BLOCK. Each is held against its plain version at N=1003 for 3
   steps and at full width for 1, the leaves drawn with numpy from a seed
   (`model.examples.random_leaves`), and must differ from the same step
   without leaves; each is driven through `physics_step_fused` or a
   randomized VecTask with the launches counted; each is timed;
15. physical checks: an Ant in free fall under per-env gravity gains
   qd = g_i t on all three axes; Ant with `task.randomize=True` (per-body
   mass factors in [0.5, 1.5]) settles with its summed foot force near each
   env's OWN weight (the spread over envs of fz / own weight must be well
   under that of fz / nominal weight);
16. the DR main path at full width: device ops per Ant env step with and
   without `task.randomize=True`, `bench --randomize`, one warm-up and one
   timed `train_epoch` of `task=Ant task.randomize=True` (16 launches),
   then `train.main` with `task=Ant task.randomize=True` for ANT_DR_EPOCHS
   epochs, a restore that is bit-equal (the DR sample is drawn anew, as in
   the JAX package) and `play`; Cartpole, Ingenuity, Quadcopter and
   BallBalance step with `task.randomize=True` and DR_BLOCK passed in;
17. Anymal (44 plane contacts, `q_target`), AnymalTerrain (top-K cap of 20,
   terrain rows, the friction leaf, 4 decimation slices merged into one
   launch) and AnymalTerrain on its plane (top-K alone), built in step 2
   beside the others, each against its plain version for one env step's
   physics call at N=1003 and 4096, robots standing and (one env in 16)
   tumbled with more than 20 candidates active; the inputs are drawn twice
   over and kept where float32 rounding is small (`conditioned`), the
   terrain grid moved next to the world origin;
18. one merged window against four separate launches: equal on the plane
   (bar 1e-6), printed on terrain;
19. physical checks: Anymal standing at its default pose (feet fz 0.9-1.3 x
   weight, knees and base free, base height steady over 10 steps);
   AnymalTerrain on every terrain type and level (finite, base above the
   local ground after 100 steps); a 30-step episode whose levels move both
   ways;
20. 1 + 1 full-width epochs of Anymal and AnymalTerrain (batch 98,304, 24
   launches each), device ops per AnymalTerrain env step,
   `train.main task=AnymalTerrain` for 2 epochs with a bit-equal restore,
   the plane variant driven for 16 env steps;
21. the three kernels timed at full width;
22. FactoryTaskInsertion (64 plane rows and 64 SDF rows against the
   socket's voxel grid, the cap of 32, `q_target`, gravity compensation
   through `xfrc`; eight envs per block, from its shared memory) against its
   plain version for one env step at N=1003, 128 (its yaml) and 4096, in
   contact states with SDF rows active in most envs and the cap binding in
   some (kept where the keys at the cap differ by more than KEY_GAP); the
   ball on an SDF box (one SDF row, no cap) at N=1003 for 3 steps;
23. the ball dropped onto the SDF box rests at 0.45 +- 0.015 m with
   |qd_z| < 0.05 after 150 steps through `physics_step_fused`;
24. 1 + 1 Insertion epochs at the yaml's width (128 envs, batch 4,096, 32
   launches each), device ops per Insertion env step, `train.main
   task=FactoryTaskInsertion` for INSERTION_EPOCHS epochs with a bit-equal
   restore and play (its return is zero);
25. both timed (Insertion at 128 and 4096 envs, the ball at 4096) with
   envs per block and shared memory per block;
26. Humanoid (nv 27: 27 of a warp's 32 dof lanes, the Gram product's k
   padded to 32; 35 plane contacts, no cap; eight envs per block) against
   its plain version at N=1003 for 3 steps and at 4096 for one, both feet
   on the ground, the inputs kept where rounding alone moves the step by
   at most COND_TOL (`humanoid_inputs`);
27. 1 + 1 full-width Humanoid PPO epochs (`load_config(["task=Humanoid"])`:
   4096 envs, horizon 32, batch 131,072, minibatch 32,768, 5 mini-epochs;
   32 launches each), device ops per Humanoid env step;
28. Humanoid SAC (`train=HumanoidSAC`, 4096 envs, batch 4,096, a buffer of
   1,000,000): epochs past the warm-up, two timed (8 launches each, buffer
   = steps x 4096, alpha > 0, finite losses), the actor and critics moved,
   the targets moved by tau, a bit-equal save/restore, `test=True` play;
29. the four recipes through `train.main` at their yaml widths
   (`task=Humanoid`, `task=Humanoid train=HumanoidSAC`, `task=Ant
   train=AntSAC`, `task=AnymalTerrain train=AnymalTerrainPPO_LSTM`):
   RECIPE_EPOCHS epochs; a resume from the checkpoint and play for one
   recipe per learner (RESUMED: feed-forward PPO, SAC, the LSTM);
30. 1 + 1 full-width AnymalTerrain epochs with `train=AnymalTerrainPPO_LSTM`
   (batch 98,304 in 24,576 windows of 4, 6 minibatches of 4,096 windows x 5;
   24 launches each): the carry of the envs done in the last step is zero,
   every other env's is not;
31. two Ant rollouts at 4096 envs from one seed are bit-equal: env.step
   alone, and PPO.rollout with the policy;
32. the Humanoid kernel timed at 4096 envs;
33. HumanoidAMP (nv 34: two dofs per lane, five k-tiles of the Gram product
   with k padded to 40; 42 plane contacts under the top-K cap of 16,
   `q_target`; eight envs per block) against its plain version for 3 env
   steps (6 calls) at N=1003 and 4096, from states of the motion clip and
   (one env in 16) lying on its back with more candidates in the margin
   than the cap, kept where rounding alone moves each call by at most
   COND_TOL (`amp_inputs`);
34. 1 + 1 full-width AMP epochs (`load_config(["task=HumanoidAMP"])`, 4096
   envs, horizon 16, batch 65,536, minibatch 32,768, 6 mini-epochs, MLP
   [1024, 512] separate, discriminator [1024, 512] on 210-wide windows; 32
   launches each, finite kl, disc_acc and disc_reward_mean), device ops per
   HumanoidAMP env step;
35. `train.main task=HumanoidAMP`: 2 epochs, a bit-equal restore (policy,
   discriminator, the three normalizers, Adam), a resume, play;
36. HRL on HumanoidAMP at 4096 envs (`train.params.algo.name=hrl_continuous`,
   the seeded `amp_latent` LLC): one macro step advances `progress` by
   llc_steps, then `train.main` for 2 epochs, a resume and play;
37. the HumanoidAMP kernel timed at 4096 envs;
38. FrankaCubeStack (nv 21, two free cubes; 40 BOX pair rows, no plane
   rows, under the top-K cap of 20; `q_target` finger drives) and
   FrankaCabinet (nv 13; 24 pair rows against the handle bar, a MESH geom
   on the cylinder branch, under the cap of 16; finger drives of stiffness
   1e6) against their plain versions for 3 env steps at N=1003 and at full
   width (8192, 4096), from the tasks' `contact_states` (the cubes on the
   table, cube A on cube B, cube A between the fingers; the hand or a
   finger on the handle bar) under FrankaCubeStack's OSC torques, kept
   where rounding alone moves each call by at most COND_TOL
   (`franka_inputs`);
39. FrankaCubeStack's OSC at 8192 envs: a +x task-space increment gives +x
   grip-site acceleration in every env, and the torques, mass matrix,
   inverse and Jacobian equal the CPU's from the same inputs (rtol 1e-4);
40. 1 + 1 full-width PPO epochs of both (FrankaCubeStackPPO.yaml: batch
   262,144, 16 minibatches x 5, 32 launches each; FrankaCabinetPPO.yaml:
   65,536 in 8 x 8, 16 launches each), and the OSC's share of a
   FrankaCubeStack env step by wall time and device ops;
41. `train.main` for both: 2 epochs, a bit-equal restore;
42. both Franka kernels timed at full width;
44. the Factory nut-bolt family (rows 1x-1z: Pick, Place and Screw, nv 17;
   12 rims, 48 thread points and each task's pad points as plane rows and
   as SDF rows, the pads against the free nut's grid and the nut's points
   against the grid of the bolt on its two slides, under the cap of 16;
   `q_target`, gravity compensation through `xfrc`; envs per block from
   shared memory) against their plain versions for 3 env steps (each under
   the task's controller at zero actions and its SDF planes sampled at the
   step's entry) at N=1003 and the yaml's 128, from the tasks'
   `contact_states` kept where rounding alone moves each call by at most
   COND_TOL (`nutbolt_inputs`), with contact force on the nut and on the bolt;
45. the behaviour of tests/test_factory_nut_bolt.py through the kernel at
   128 envs: a free nut rests on the threads and keeps to the helix (the
   Screw model, the arm parked), Place keeps its grip for 60 steps and its
   scripted carry succeeds in every env within 150, Screw's
   press-and-rotate turns the nut past 60 degrees along the helix;
46. NutBoltPick's device ops and the device's busy share per env step;
47. `train.main task=FactoryTaskNutBoltPick`: 1 epoch at the yaml's width
   (128 envs, horizon 120, minibatch 512 x 8 mini-epochs), a bit-equal
   restore (Place and Screw run through the kernel in step 45);
48. the three kernels timed at 128 and 4096 envs;
49. IndustReal (PegsInsert: 17 bodies, nv 19, the plug's 76 points and 12
   pad points as plane rows and SDF rows, the plug's against the grid of
   the socket on three slides and a yaw hinge, the pads' against the free
   plug's, under the cap of 32 of 176 rows, eight envs per block;
   GearsInsert: the gear's 50 bore, 24 bottom and 40 pad points, three
   grids, the shaft's crop and the whole base's on the base's yaw body,
   under the cap of 64 of 228 rows, four envs per block: the first build
   with more slots than a warp has lanes) against their plain versions for
   3 env steps at N=1003 and one at the yaml's 128, each under the task's
   task-space impedance at zero actions and its SDF planes, from the tasks'
   `contact_states` kept where rounding alone moves each call by at most
   COND_TOL (`industreal_inputs`; Gears only states with 33 rows in the
   margin or more), with the count of rows in the margin printed;
50. the behaviour of tests/test_industreal.py through the kernel at 128
   envs: PegsInsert's straight push completes the insertion in
   PEGS_PUSH_SHARE of the envs or more, GearsInsert's press and hold in
   GEARS_HOLD_SHARE, and SBC steps the max displacement toward easier after
   failed episodes in every env;
51. per task env.step env-steps/s at 128 envs (4 steps after 4), device ops and the device's
   busy share per env step, and the reset's 24 IK iterations alone (wall
   ms and device ops of a step where some env resets; the same code in
   both tasks);
52. `train.main task=IndustRealTaskPegsInsert` at the yaml's width for 2
   epochs (PPORecurrent; the 256-step episodes end in the second, and the
   SBC update follows `new_max_disp` for the success rate it saw), a
   bit-equal restore; one GearsInsert epoch through
   `PPORecurrent.train_epoch` at 128 x 128 with GEARS_UPDATE_STEPS of its
   16,384 minibatch steps (of 8 windows), the full epoch derived;
53. both IndustReal kernels timed at 128 and 4096 envs;
54. Trifinger (14 bodies, nv 15; the cube's 8 corners and the 3 tips as
   plane rows, the tips against the cube as pair rows, no cap, 4 substeps;
   its yaml's domain randomization: 8 per-env leaves), ShadowHand (nv 30;
   114 pair rows of the hand's candidates against the object, no plane
   rows, under the cap of 24; `q_target`; 4 fixed tendons) and AllegroHand
   (nv 22; 144 pair rows under the cap of 24; `q_target`; 2 control slices)
   against their plain versions for 2 env steps at N=1003 from the tasks'
   `contact_states` (the fingertips on the cube; the object on the palm),
   each call under `hand_calls` (Trifinger's safety damping at zero
   actions, the hands' setpoints held) at the plain output of the one
   before, kept by `conditioned` and `kernel_jitter_ok` (`hand_inputs`):
   contact force on the object in half of the envs or more, and more rows
   in ShadowHand's margin than the cap in some env; then ShadowHand's
   build under ShadowHandOpenAI_FF.yaml (HAND_FF: 13 per-env leaves of its
   domain randomization, a random force on the object as xfrc, 3 control
   slices) the same way for one env step;
55. the JAX package's hand bars through the kernel at 16,384 envs: the
   object rests on the palm after 60 zero-action steps in PALM_SHARE of
   the envs (ShadowHand, AllegroHand), and Trifinger's position mode tracks
   the default pose (TRACK_BAR);
56. per task env.step env-steps/s at 16,384 envs (ShadowHand's device ops
   per env step), and one warm-up and one timed PPO epoch at the yaml's width
   (batch 131,072);
57. the three hand kernels timed at 16,384 envs;
58. AllegroKuka with one arm (28 bodies, nv 29; the cube's 8 corners
   against the table and six candidates per fingertip against the cube as
   32 pair rows, no plane rows, no cap; `q_target`) and two arms (54
   bodies, nv 52, two dofs per lane; 56 pair rows) against their plain
   versions for 2 env steps at N=1003 and one at the yaml's 8,192 envs,
   from the tasks' `contact_states` (the cube resting on the highest
   fingertip or on the table) under their PD targets held at the joints,
   kept by `conditioned` and `kernel_jitter_ok` (`kuka_inputs`): a
   fingertip row within the margin in half of the envs or more, contact
   force on the cube in nine in ten; then the one arm under its yaml's
   domain randomization (10 per-env leaves and gravity) for one env step;
59. the JAX package's cube-rest bar through the kernel at 8,192 envs:
   after 25 zero-action steps the cube lies within 5 mm of its rest height
   in KUKA_REST_SHARE of the envs;
60. per family env.step env-steps/s at 8,192 envs (the one arm's device
   ops and busy share per env step), one warm-up and one timed PPO epoch
   at the yaml's width (batch 65,536);
61. `train.main task=AllegroKukaReorientation` and `task=AllegroKukaTwoArms`
   at 8,192 envs: 2 epochs, a bit-equal restore;
62. the initial-state bank: `train.main` with task.env.saveStates=True
   writes it, and an env with loadInitialStates resets every env to one
   of its rows (also a partial reset within env.step);
63. both AllegroKuka kernels timed at 8,192 envs;
64. DeXtreme: AllegroHand's model (row 1ae) under the per-env leaves of
   AllegroHandDextremeADR.yaml (row 1ah: dof damping, stiffness, friction,
   armature, masses, friction and restitution; the restitution's bounce
   branch on the pair rows) and of AllegroHandDextremeManualDR.yaml (row
   1ah': its own leaves and gravity) against their plain versions at
   N=1003 for 2 (ManualDR: 1) env steps, on the task's contact states
   (`hand_inputs`) with leaves drawn through ADR's overrides
   (`dextreme_overrides`: ranges moved out, each physics parameter pinned
   at both edges in some envs);
65. per task env.step env-steps/s at 8,192 envs, the yaml's randomization
   and ADR on (ADR's device ops and busy share per env step), one warm-up
   and one timed PPO epoch at the yaml's width (batch 131,072);
66. a forced ADR run at 8,192 envs (FORCED_ADR: queues of 8, an upper
   threshold of 0, episodes of 4 steps): ADR's entropy and ranges move on
   the card;
67. `train.main` for both at 8,192 envs with ADR's checkpoint gate on: 2
   epochs, a bit-equal restore (ADR's state included); for the ADR task a
   resume and play;
68. both DeXtreme kernels timed at 8,192 envs;
69. `isaacgymenvs_tpu_torch.make(task="Ant")` on its default device: the
   env of the yaml's 4096 envs steps once through the kernel;
70. PBT (`pbt_population`): one Ant member alone for PBT_ALONE_EPOCHS
   epochs, then two members of one population launched together by
   `pbt.launcher.run_local` (`python -m isaacgymenvs_tpu_torch.train
   task=Ant pbt=pbt_default ...`, 4096 envs, episodes of 48 steps, an
   interval, warm-up and delay of one epoch's frames, thresholds 0, member
   0 at learning rate 0) for PBT_EPOCHS epochs each: both exit 0, both
   write records into the shared workspace, a trailing member restarts
   from the other's weights (restored bit for bit) with mutated params
   inside their bounds; epoch seconds from record to record, two members
   against one alone;
71. HumanoidAMPHands at 4096 envs: its fused build is row 1u's; from the
   cartwheel clip's reference states, envs with a hand pressed on the
   ground are not ended (HumanoidAMP's rule would end them); `train.main
   task=HumanoidAMPHands` with the recipe the JAX package resolves for it
   (none: PPO's defaults) for one epoch, a bit-equal restore, play;
72. data parallelism, two ranks on the one card under gloo (NCCL refuses
   two ranks on one device): `python -m torch.distributed.run
   --nproc_per_node=2 -m isaacgymenvs_tpu_torch.train task=Ant
   multi_gpu=True dist_backend=gloo` for DP_TRAIN_EPOCHS epochs (both
   ranks exit 0, rank 0 alone prints and logs); then one process of two
   ranks (`--dp-rank`, `parallel.distributed.start_ranks`) takes one
   process's Ant reset state at 4096 envs (2048 each), action noise and
   permutations (DP_CASES: the global shuffle, local_shuffle, and the
   global shuffle under local_shuffle's noise as the control of the two)
   and runs two epochs of each: one on the one process's rollout, each
   rank its block (`traj_block`), whose kl, a_loss and c_loss lie within
   rtol 2e-4 / atol 2e-6 (DP_TOL) of the one-process epoch's, whose first
   minibatch step's gradient, as the optimizer took it, lies within
   DP_GRAD_EPS float32 eps of its largest element from the float64
   gradient of that minibatch (`grad64`), and whose
   parameters after that step lie within DP_TOL of the one process's; and
   one from its own rollout, whose mean reward lies within DP_TOL (the
   global shuffle's losses too), no episode ended, and whose reward gap
   per env to the one process is printed (the ranks' policy and
   normalizers round otherwise than one process's, and contacts can part
   two rollouts that start ulps apart). The ranks' parameters and metrics
   are bit-equal after every epoch; the largest parameter gaps to one
   process are printed beside (Adam scales each element's step by its own
   gradient's size, so over the epoch's 8 steps a rounding difference in
   a small gradient can move an element by up to lr); the two-rank
   epoch's env-steps/s beside the one-process epoch's; both ranks restore
   train.main's checkpoint bit for bit. The one-process epochs run before
   step 44; the torchrun run and the rank pair then run beside steps 44-45
   (host-bound comparisons and bars, whose results hang on no clock) and
   are waited for before step 46's timings; their checks are printed here;
73. one PPORecurrent epoch of AnymalTerrainPPO_LSTM with local_shuffle at
   1,024 envs on the two ranks (each rank from its own reset: the ranks
   bit-equal);
74. ADR over the two ranks: AllegroHandDextremeADR at 8,192 envs (4,096
   each) under FORCED_ADR for FORCED_STEPS steps; in every update the
   ranges, queues, counts and entropy are bit-equal across the ranks and
   equal to one process's update on the gathered inputs; no instantiation
   the ranks load is new. Then one Ant epoch at one rank under NCCL,
   through the group's collectives (a group of one rank formed by the
   step itself: `maybe_initialize` forms none at world size 1);
75. FactoryTaskGears (row 1ai: 120 plane and 120 SDF rows under the cap
   of 96, the first build with three slots per lane) on its default route,
   the kernel, at the yaml's 128 envs: its size tuple, envs per block,
   shared memory, registers and spills; the kernel against its plain
   version for GEARS_STEPS env steps from its `contact_states` (filtered
   by `conditioned` and `kernel_jitter_ok`, as the nut-bolt and IndustReal
   comparisons); the kernel timed with its bound, env.step env-steps/s and
   device ops per env step; `train.main` for 2 epochs, a bit-equal
   restore, a resume and play;
76. FactoryTaskGears on the eager engine (`task.sim.use_fused=False`) at
   128 envs: the route is "eager" and the kernel's launch count does not
   move; GEARS_STEPS eager steps in float32 against the same steps in
   float64 on the card from step 75's states, each from the float64
   state, within q 2e-4, qd 2e-3, forces 2e-2; env.step env-steps/s and
   device ops per env step; `train.main` for 2 epochs, a bit-equal
   restore, a resume and play, without a kernel launch;
77. the other eager cases on the card, a few steps each, the route "eager"
   and the state finite: BallBalance under `use_fused=False` (anchors and
   a pair row), the pair-row example under `solver: pgs`, and
   FactoryTaskInsertion with its plug scaled per env (per-env candidate
   points with SDF rows, which raised before). Every env this script
   resets outside steps 76-77 takes the kernel route (`watch_routes`);
78. prints one `kernels` JSON line with all instantiations (each with its
   envs per block, shared memory per block, resident blocks and warps per
   SM, ptxas's registers and spill bytes; row 1a's launches of the ranks
   as `launches_multi_rank`) and ends with {"ok": true, "device": {...}}.

It needs a CUDA device and the repository around it; without either it
exits non-zero before printing a result.
"""
from __future__ import annotations

import glob
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from contextlib import contextmanager

import numpy as np
import torch

NUM_ENVS = 4096
HORIZON = 16
RAGGED_ENVS = 1003
# timed calls of a plain version (after one warm-up): each takes 30-720 ms on the host, and the script times
# 43 of them against its 1,200 s limit
PLAIN_REPS = 2
CARTPOLE_ENVS = 512  # numEnvs of cfg/task/Cartpole.yaml
CARTPOLE_EPOCHS = 100
# Mean episode return Cartpole must pass after 100 epochs, in training and
# in play. An untrained policy returns 1-3 and an episode ends at 500 steps
# of reward <= 1. The first run of this script on an NVIDIA H100 80GB HBM3
# (700 W) trained to 359.88 and played to 498.62; the bar leaves a margin
# of 3.6x.
RETURN_BAR = 100.0
TOL = {"q": 2e-4, "qd": 2e-3, "body_force": 2e-2, "body_torque": 2e-2, "dof_force": 2e-2}
BALL_TOL = {**TOL, "q": 5e-4}
# the procedural-model tasks at the width of their yaml: (envs, horizon)
NEW_TASKS = {"Ingenuity": (4096, 16), "Quadcopter": (8192, 8), "BallBalance": (4096, 16)}
BALL_EPOCHS = 40
# Mean episode return BallBalance must pass after BALL_EPOCHS epochs of 65,536
# env steps: the mean over the run's epochs, as `train` reports it, and the
# mean of the episodes that ended in the last epoch. The first ten epochs
# average 11 (a policy that has learnt nothing yet); the first run of this
# phase on an NVIDIA H100 80GB HBM3 (700 W) gave 30.56 over the run and 65.39
# in the last epoch, so the bars leave margins of 1.5x and 2.2x.
BALL_RETURN_BAR = 20.0
BALL_LAST_EPOCH_BAR = 30.0
ANCHOR_TOL = 0.005  # metres between a settled anchor point and its target
ANT_DR_EPOCHS = 5
ANT_YAML_LEAVES = ("dof_damping", "dof_stiffness", "dof_limit_lower", "dof_limit_upper", "body_mass")
PAIR_ROW_LEAVES = ("body_mass", "cpoint_friction", "cpoint_pos", "geom_size")
# a randomization block for the tasks whose yaml has none; its leaves in the step's order
DR_BLOCK = {
    "frequency": 2,
    "observations": {"range": [0, 0.002], "operation": "additive", "distribution": "gaussian"},
    "actions": {"range": [0.0, 0.02], "operation": "additive", "distribution": "gaussian"},
    "sim_params": {"gravity": {"range": [0, 0.4], "operation": "additive", "distribution": "gaussian"}},
    "actor_params": {"robot": {
        "rigid_body_properties": {"mass": {"range": [0.5, 1.5], "operation": "scaling", "distribution": "uniform"}},
        "rigid_shape_properties": {"friction": {"range": [0.5, 1.5], "operation": "scaling", "distribution": "uniform"}},
        "dof_properties": {"damping": {"range": [0.5, 1.5], "operation": "scaling", "distribution": "loguniform"}},
    }},
}
DR_BLOCK_LEAVES = ("dof_damping", "body_mass", "cpoint_friction", "gravity")
DR_TASKS = {"Cartpole": CARTPOLE_ENVS, "Ingenuity": 4096, "Quadcopter": 8192, "BallBalance": 4096}
# data-sheet peaks of the H100 parts: (fp32 FLOP/s outside the tensor
# cores, memory bytes/s); the SXM part unless the name says otherwise
PEAKS = {"PCIe": (51.2e12, 2.0e12), "NVL": (60e12, 3.9e12), "SXM": (67e12, 3.35e12)}


def peaks(name: str):
    return next((PEAKS[k] for k in ("PCIe", "NVL") if k in name), PEAKS["SXM"])


def ant_env(n: int):
    from isaacgymenvs_tpu_torch.tasks import task_map

    cfg = {"env": {"numEnvs": n, "clipActions": 1.0}, "sim": {"dt": 1 / 60, "substeps": 2}}
    return task_map["Ant"](cfg, device="cuda")


def cartpole_env(n: int):
    from isaacgymenvs_tpu_torch.tasks import task_map

    cfg = {"env": {"numEnvs": n, "clipObservations": 5.0, "clipActions": 1.0},
           "sim": {"dt": 0.0166, "substeps": 2}}
    return task_map["Cartpole"](cfg, device="cuda")


def task_env(name: str, n: int, randomize: bool = False, device: str = "cuda"):
    """A task of the port from its own yaml at `n` envs; with `randomize`,
    domain randomization on (Ant: the block of its yaml, else DR_BLOCK)."""
    from isaacgymenvs_tpu_torch.tasks import task_map
    from isaacgymenvs_tpu_torch.utils.config import load_config

    cfg = load_config([f"task={name}", f"num_envs={n}", f"task.randomize={randomize}"])["task"]
    if randomize and name != "Ant":
        cfg["task"]["randomization_params"] = DR_BLOCK
    return task_map[name](cfg, device=device)


def example_model(tendons: bool = False):
    """The example model with BOX and SPHERE pair rows (or, with `tendons`,
    the arm with a fixed tendon pressing on a box) and its parameters, as an
    object with `.model` and `.sim_params` like a task."""
    from types import SimpleNamespace

    from isaacgymenvs_tpu_torch.engine.dynamics import SimParams
    from isaacgymenvs_tpu_torch.model.examples import pair_row_example, tendon_chain_example

    model = tendon_chain_example() if tendons else pair_row_example()
    return SimpleNamespace(model=model, use_pd_targets=False, sim_params=SimParams(
        dt=1 / 60, substeps=2, solver_apgd_iterations=16, contact_margin=0.02))


# chassis heights at which the lowest contact candidates rest up to 1 mm in
# the ground: a deeper start is pushed out in the first slice and the last
# slice, whose forces the step returns, sees no contact
GROUND_HEIGHT = {"Ingenuity": (0.059, 0.06), "Quadcopter": (0.014, 0.015)}


def contact_inputs(name: str, env, n: int, seed: int, light: bool = False):
    """Gentle inputs (q, qd, qfrc, xfrc, q_target), env-leading, in a state
    where the contact rows of `name` act. `light`: the step will run with
    per-env masses down to half the model's. Quadcopter's q_target offsets
    drive its rotor arms against a 47 g chassis, whose angular velocity
    carries the comparison's largest error: 1.4e-3 of the 2e-3 allowed
    without per-env leaves, 2.0-2.3e-3 with halved masses or per-env
    gravity, 0.9e-3 with the offsets halved as well (all measured on an
    NVIDIA H100 80GB HBM3). So a light step gets half the offsets."""
    from isaacgymenvs_tpu_torch.model.examples import pair_row_example_state, tendon_chain_example_state

    m = env.model
    rng = np.random.RandomState(seed)
    cuda = lambda a: torch.tensor(np.asarray(a, np.float32), device="cuda")
    u = lambda lim, *shape: cuda(rng.uniform(-lim, lim, shape))
    if name == "Example":
        q, qd = (cuda(a) for a in pair_row_example_state(m, n, seed))
        return q, qd, u(0.3, n, m.nv), u(0.2, n, m.nbody, 6), None
    if name == "Tendon":
        q, qd = tendon_chain_example_state(m, n, seed)
        qd[::2, 2] = -0.6  # half the boxes come down faster than the bounce threshold
        return cuda(q), cuda(qd), u(0.3, n, m.nv), u(0.2, n, m.nbody, 6), None
    if name in ("Ant", "Cartpole"):
        state, _ = env.reset(seed)
        xfrc = u(1.0, n, m.nbody, 6) if name == "Ant" else None
        return state.sim.q, state.sim.qd, u(3.0 if name == "Ant" else 100.0, n, m.nv), xfrc, None
    if name == "BallBalance":
        q = env.qpos0.repeat(n, 1)
        q[:, env.ball_q:env.ball_q + 2] = u(0.2, n, 2)
        q[:, env.ball_q + 2] = env.tray_height + 0.01 + env.ball_radius - 0.002  # 2 mm into the tray
        return q, torch.zeros(n, m.nv, device="cuda"), u(0.5, n, m.nv), None, q + u(0.02, n, m.nq)
    state, _ = env.reset(seed)
    q = state.sim.q.clone()
    lo, hi = GROUND_HEIGHT[name]
    q[::3, 2] = cuda(rng.uniform(lo, hi, len(q[::3])))
    qt = q + u(0.05 if light else 0.1, n, m.nq) if env.use_pd_targets else None
    qd = u(0.1, n, m.nv)
    qd[::3] = 0.0  # the grounded envs start at rest
    # gentle: a Quadcopter rotor arm weighs under a gram, so a wrench of 1 N
    # would spin it to velocities whose float32 rounding alone passes 2e-3
    return q, qd, u(0.02, n, m.nv), u(0.02, n, m.nbody, 6), qt


def settle_ball_balance(n: int) -> None:
    """Zero actions with the ball on the tray: the anchors hold the feet at
    their targets and the tray carries the ball's weight."""
    from isaacgymenvs_tpu_torch import maths
    from isaacgymenvs_tpu_torch.engine import dynamics

    env = task_env("BallBalance", n)
    state, _ = env.reset(5)
    q, qd, _, _, _ = contact_inputs("BallBalance", env, n, seed=12)
    q[:, env.ball_q:env.ball_q + 2] *= 0.5  # within 0.1 m of the centre
    state.sim = dynamics.SimState(q=q, qd=qd)
    zero = torch.zeros(n, env.num_acts, device="cuda")
    for _ in range(150):
        state, obs, _, _, _ = env.step(state, zero)
    m = env.model
    kin = dynamics.forward_kinematics(m, state.sim.q, state.sim.qd)
    feet = list(m.att_body)
    offset = torch.tensor(np.asarray(m.att_offset, np.float32), device="cuda")
    target = torch.tensor(np.asarray(m.att_target, np.float32), device="cuda")
    points = kin.x[:, feet] + maths.quat_rotate(kin.quat[:, feet], offset)
    dist = float(torch.linalg.vector_norm(points - target, dim=-1).max())
    weight = float(m.body_mass[env.ball_body]) * 9.81
    on_tray = state.sim.q[:, env.ball_q + 2] > env.tray_height  # not dropped and reset
    ratio = float((-obs[:, 14] * 20.0)[on_tray].mean()) / weight
    print(f"settled BallBalance: anchor points within {dist:.5f} m of their targets (max over {n} envs), "
          f"tray fz / ball weight {ratio:.4f}, ball on the tray in {100 * float(on_tray.float().mean()):.1f} % of envs")
    if not dist < ANCHOR_TOL or not 0.8 < ratio < 1.25 or not float(on_tray.float().mean()) > 0.9:
        raise AssertionError(f"BallBalance did not settle: anchors {dist:.4f} m, tray force {ratio:.3f} x weight")


def settle_example(n: int) -> int:
    """The example model through `physics_step_fused` for 60 steps with no
    applied force: each sphere's contact force is about its weight. Returns
    the launches."""
    from isaacgymenvs_tpu_torch.engine import _cuda, fused

    ex = example_model()
    m = ex.model
    q, _, _, _, _ = contact_inputs("Example", ex, n, seed=13)
    qd = torch.zeros(n, m.nv, device="cuda")
    zero = torch.zeros(n, m.nv, device="cuda")
    torch.cuda.synchronize()
    _cuda.FusedStepCall.launches = 0
    for _ in range(60):
        out = fused.physics_step_fused(m, ex.sim_params, q, qd, zero)
        q, qd = out.q, out.qd
    torch.cuda.synchronize()
    launches = _cuda.FusedStepCall.launches
    ratios = [float(out.body_force[:, b, 2].mean()) / (float(m.body_mass[b]) * 9.81) for b in (1, 2)]
    print(f"settled example model: sphere contact fz / weight {ratios[0]:.4f}, {ratios[1]:.4f} "
          f"(mean over {n} envs), {launches} launches")
    if launches != 60 or not all(0.8 < r < 1.25 for r in ratios) or not bool(torch.isfinite(q).all()):
        raise AssertionError(f"the example model did not settle: {ratios}, {launches} launches")
    return launches


def train_ball_balance() -> int:
    """BallBalance through `train.main` at the yaml's 4096 envs for
    BALL_EPOCHS epochs, then play from the checkpoint. Returns the kernel
    launches of the training run."""
    from isaacgymenvs_tpu_torch import train
    from isaacgymenvs_tpu_torch.engine import _cuda

    envs, horizon = NEW_TASKS["BallBalance"]
    with tempfile.TemporaryDirectory() as runs:
        torch.cuda.synchronize()
        _cuda.FusedStepCall.launches = 0
        t0 = time.perf_counter()
        ts, metrics = train.main(["task=BallBalance", f"max_iterations={BALL_EPOCHS}", f"+train_dir={runs}"])
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
        launches = _cuda.FusedStepCall.launches
        steps = BALL_EPOCHS * horizon
        if launches != steps or metrics["frames"] != steps * envs:
            raise AssertionError(f"{launches} launches, {metrics['frames']} frames for {steps} env steps")
        ret = metrics["mean_episode_return"]
        last = metrics["ep_return_sum"] / max(metrics["n_episodes"], 1)
        print(f"BallBalance train: {BALL_EPOCHS} epochs x {envs} envs in {sec:.2f} s "
              f"({metrics['frames'] / sec:.1f} env-steps/s with set-up), {launches} launches, mean episode "
              f"return {ret:.2f} over the run (bar {BALL_RETURN_BAR}), {last:.2f} in the last epoch "
              f"(bar {BALL_LAST_EPOCH_BAR})")
        if not ret > BALL_RETURN_BAR or not last > BALL_LAST_EPOCH_BAR:
            raise AssertionError(f"BallBalance trained to {ret:.2f} / {last:.2f}, not past "
                                 f"{BALL_RETURN_BAR} / {BALL_LAST_EPOCH_BAR}")
        ckpt = os.path.join(runs, "BallBalance", "nn", "last_BallBalance.pth")
        played = train.main(["task=BallBalance", "test=True", f"checkpoint={ckpt}"])
        print(f"BallBalance play: mean return of the first episodes to end {played:.2f}")
        if not np.isfinite(played):
            raise AssertionError("BallBalance play returned a non-finite mean return")
    return launches


# ---- per-env leaves (domain randomization) and tendons -----------------------

# instantiations beyond Ant's and Cartpole's: key -> (what `contact_inputs`
# calls the model, the per-env leaves ("all": every leaf with rows on the
# model, and gravity), the full width). First those without per-env leaves.
NEW_CASES = {**{t: (t, (), w[0]) for t, w in NEW_TASKS.items()}, "Example": ("Example", (), NUM_ENVS)}
DYN_CASES = {
    "Ant+yaml": ("Ant", ANT_YAML_LEAVES, NUM_ENVS),
    "Ant+all": ("Ant", "all", NUM_ENVS),
    "Tendon": ("Tendon", (), NUM_ENVS),
    "Tendon+all": ("Tendon", "all", NUM_ENVS),
    "BallBalance+pair": ("BallBalance", PAIR_ROW_LEAVES, 4096),
    **{f"{t}+dr": (t, DR_BLOCK_LEAVES, w) for t, w in DR_TASKS.items()},
}
CASES = {**NEW_CASES, **DYN_CASES}


def case(key: str, n: int):
    """(model holder, leaf names in the step's order) of a CASES entry at `n` envs."""
    from isaacgymenvs_tpu_torch.engine import fused

    base, names, _ = CASES[key]
    holder = example_model(tendons=base == "Tendon") if base in ("Tendon", "Example") else task_env(base, n)
    s = fused._extract(holder.model)
    return holder, fused.dyn_names(s, fused.DYN_ORDER if names == "all" else names)


def packed_leaves(holder, names, n: int, seed: int, only=None):
    """Per-env leaves `names` drawn with numpy from `seed`, on the card and
    packed as the step takes them (None without names). With `only`, every
    other leaf holds the model's own values in every env."""
    from isaacgymenvs_tpu_torch.engine import fused
    from isaacgymenvs_tpu_torch.model.examples import random_leaves

    if not names:
        return None
    m = holder.model
    leaves = random_leaves(m, names, n, seed, holder.sim_params.gravity)
    for k in names if only is not None else ():
        if k not in only:
            own = getattr(m, k)
            leaves[k] = np.broadcast_to(0.0 if own is None else np.asarray(own, np.float32), leaves[k].shape).copy()
    return fused.pack_dyn(fused._extract(m), {k: torch.tensor(v, device="cuda") for k, v in leaves.items()})


def compare_case(key: str) -> float:
    """A CASES instantiation against its plain version at the ragged N for 3
    steps and at full width for 1, and, with per-env leaves, against its own
    step without them; returns the largest error."""
    base, _, full = CASES[key]
    worst = 0.0
    for n, steps in ((RAGGED_ENVS, 3), (full, 1)):
        holder, names = case(key, n)
        q, qd, qfrc, xfrc, qt = contact_inputs(base, holder, n, seed=11, light="body_mass" in names)
        dyn = packed_leaves(holder, names, n, seed=22)
        # the body whose contact force shows that the rows act: the tray under
        # the ball, sphere A on the box, the arm's tip on the box, the copters'
        # chassis on the ground (a third of them rest on it)
        body = {"BallBalance": getattr(holder, "tray_body", 0), "Example": 1, "Tendon": 2,
                **dict.fromkeys(GROUND_HEIGHT, 0)}.get(base)
        err = compare_model(holder.model, holder.sim_params, q, qd, qfrc, xfrc, qt, steps,
                            tol=BALL_TOL if base == "BallBalance" else TOL, force_of=body, dyn=dyn)
        seen = err.pop("seen_force", None)
        print(f"{key} kernel vs plain, N={n}, {steps} step(s), {len(names)} per-env leaves"
              + (f" ({dyn.rows.shape[0]} rows)" if dyn is not None else "")
              + (f", body {body} pressed in {100 * seen:.1f} % of envs" if seen is not None else "") + ":",
              json.dumps(err))
        if seen is not None and not seen > (0.25 if base in GROUND_HEIGHT else 0.5):
            raise AssertionError(f"{key}: the contact rows were active in only {100 * seen:.1f} % of envs")
        worst = max(worst, *err.values())
    return worst


def drive_case(key: str, steps: int = 20) -> int:
    """`steps` steps of a CASES entry through `physics_step_fused` at full
    width, the leaves passed as a dict the way a user would; returns the launches."""
    from isaacgymenvs_tpu_torch.engine import _cuda, fused
    from isaacgymenvs_tpu_torch.model.examples import random_leaves

    base, _, n = CASES[key]
    holder, names = case(key, n)
    q, qd, qfrc, xfrc, qt = contact_inputs(base, holder, n, seed=23)
    leaves = {k: torch.tensor(v, device="cuda")
              for k, v in random_leaves(holder.model, names, n, 24, holder.sim_params.gravity).items()}
    torch.cuda.synchronize()
    _cuda.FusedStepCall.launches = 0
    for _ in range(steps):
        out = fused.physics_step_fused(holder.model, holder.sim_params, q, qd, qfrc, xfrc=xfrc, q_target=qt,
                                       dyn=leaves or None)
        q, qd = out.q, out.qd
    torch.cuda.synchronize()
    launches = _cuda.FusedStepCall.launches
    print(f"{key}: {steps} steps through physics_step_fused at N={n}, {launches} launches, "
          f"max |qd| {float(qd.abs().max()):.3f}")
    if launches != steps or not bool(torch.isfinite(q).all()) or not bool(torch.isfinite(qd).all()):
        raise AssertionError(f"{key}: {launches} launches for {steps} steps, or a state that is not finite")
    return launches


def free_fall_under_per_env_gravity(n: int, steps: int = 10) -> int:
    """An Ant dropped from 3 m with every leaf at the model's own value and
    its own gravity vector per env: after t its base moves at g_i t on all
    three axes. Runs the Ant + all leaves instantiation; returns the launches."""
    from isaacgymenvs_tpu_torch.engine import _cuda, fused

    holder, names = case("Ant+all", n)
    m, p = holder.model, holder.sim_params
    dyn = packed_leaves(holder, names, n, seed=25, only=("gravity",))
    g = dyn.rows[-3:].T  # (n, 3): gravity is the last leaf of the packed rows
    q = torch.tensor(np.asarray(m.qpos0, np.float32), device="cuda").repeat(n, 1)
    q[:, 2] = 3.0
    qd = torch.zeros(n, m.nv, device="cuda")
    zero = torch.zeros(n, m.nv, device="cuda")
    torch.cuda.synchronize()
    _cuda.FusedStepCall.launches = 0
    for _ in range(steps):
        out = fused.physics_step_fused(m, p, q, qd, zero, dyn=dyn)
        q, qd = out.q, out.qd
    torch.cuda.synchronize()
    launches = _cuda.FusedStepCall.launches
    t = steps * p.dt
    rel = float(((qd[:, :3] - g * t).abs().max(dim=1).values / (torch.linalg.vector_norm(g, dim=1) * t)).max())
    spread = float(g[:, 2].std())
    print(f"free fall under per-env gravity: {steps} steps, g_z {float(g[:, 2].min()):.3f} to {float(g[:, 2].max()):.3f} "
          f"m/s^2 over {n} envs, max |qd - g_i t| / |g_i t| = {rel:.2e}, {launches} launches")
    if not rel < 1e-3 or not spread > 0.1 or launches != steps:
        raise AssertionError(f"per-env gravity: relative error {rel:.2e}, spread of g_z {spread:.3f}")
    return launches


def settle_ant_with_randomized_mass(n: int, steps: int = 150) -> None:
    """Ant with `task.randomize=True` under zero actions: the feet carry each
    env's OWN weight (its bodies' masses times that env's factors), so the
    spread over envs of fz / own weight is small beside that of fz / nominal."""
    env = task_env("Ant", n, randomize=True)
    state, obs = env.reset(8)
    zero = torch.zeros(n, env.num_acts, device="cuda")
    for _ in range(steps):
        state, obs, _, _, _ = env.step(state, zero)
    own = env.randomizer.batched_model(state.dr)["body_mass"].sum(1) * 9.81
    nominal = float(np.sum(env.model.body_mass)) * 9.81
    fz = obs[:, 28:52].reshape(n, 4, 6)[:, :, 2].sum(1) / env.contact_force_scale
    up = state.sim.q[:, 2] > env.termination_height  # not fallen and reset
    r_own, r_nom = (fz / own)[up], (fz / nominal)[up]
    print(f"settled randomized Ant ({steps} steps, {100 * float(up.float().mean()):.1f} % of {n} envs up): "
          f"own weight {float(own.min()):.2f} to {float(own.max()):.2f} N (nominal {nominal:.2f}), "
          f"feet fz / own weight mean {float(r_own.mean()):.4f} std {float(r_own.std()):.4f}; "
          f"fz / nominal weight std {float(r_nom.std()):.4f}")
    if not 0.9 < float(r_own.mean()) < 1.3 or not float(r_own.std()) < 0.5 * float(r_nom.std()) \
            or not float(up.float().mean()) > 0.9:
        raise AssertionError("the randomized Ant's feet do not carry each env's own weight")


def step_randomized_tasks() -> dict:
    """Cartpole, Ingenuity, Quadcopter and BallBalance with `task.randomize=True`
    and DR_BLOCK passed in, 8 env steps at the yaml's width under random
    actions; returns the launches per task."""
    from isaacgymenvs_tpu_torch.engine import _cuda

    out = {}
    for t, n in DR_TASKS.items():
        env = task_env(t, n, randomize=True)
        state, _ = env.reset(9)
        if state.dyn.names != DR_BLOCK_LEAVES:
            raise AssertionError(f"{t}: per-env leaves {state.dyn.names}")
        gen = torch.Generator(device="cuda").manual_seed(10)
        act = lambda: torch.rand(n, env.num_acts, generator=gen, device="cuda") * 2 - 1
        state, obs, _, _, _ = env.step(state, act())  # warm-up: loads the kernel
        torch.cuda.synchronize()
        _cuda.FusedStepCall.launches = 0
        t0 = time.perf_counter()
        for _ in range(8):
            state, obs, _, _, _ = env.step(state, act())
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
        out[t] = _cuda.FusedStepCall.launches
        print(f"{t} task.randomize=True: 8 env steps x {n} envs, {out[t]} launches, {8 * n / sec:.1f} env-steps/s, "
              f"{state.dyn.rows.shape[0]} per-env rows, frames {int(state.frames)}")
        if out[t] != 8 * env.control_freq_inv or not bool(torch.isfinite(obs).all()) or int(state.frames) != 9:
            raise AssertionError(f"{t} with domain randomization: {out[t]} launches, or observations not finite")
    return out


def train_ant_randomized() -> int:
    """`train.main task=Ant task.randomize=True` for ANT_DR_EPOCHS epochs at the
    yaml's width, a bit-equal restore into a fresh agent (whose DR sample is
    its own draw) and play. Returns the kernel launches of the training run."""
    from isaacgymenvs_tpu_torch import train
    from isaacgymenvs_tpu_torch.engine import _cuda

    with tempfile.TemporaryDirectory() as runs:
        args = ["task=Ant", "task.randomize=True", f"max_iterations={ANT_DR_EPOCHS}", f"+train_dir={runs}"]
        torch.cuda.synchronize()
        _cuda.FusedStepCall.launches = 0
        t0 = time.perf_counter()
        ts, metrics = train.main(args)
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
        launches = _cuda.FusedStepCall.launches
        steps = ANT_DR_EPOCHS * HORIZON
        bad = {k: v for k, v in metrics.items() if not np.isfinite(v) and k != "mean_episode_return"}
        if launches != steps or metrics["frames"] != steps * NUM_ENVS or bad:
            raise AssertionError(f"{launches} launches, {metrics['frames']} frames for {steps} env steps; {bad}")
        st = ts.env_state
        if st.dyn.names != ANT_YAML_LEAVES or int(st.frames) != steps:
            raise AssertionError(f"the trained env state carries {st.dyn.names}, frames {int(st.frames)}")
        print(f"Ant task.randomize=True train: {ANT_DR_EPOCHS} epochs x {NUM_ENVS} envs in {sec:.2f} s "
              f"({metrics['frames'] / sec:.1f} env-steps/s with set-up), {launches} launches, "
              f"mean episode return {metrics['mean_episode_return']:.2f}")
        ckpt = os.path.join(runs, "Ant", "nn", "last_Ant.pth")
        fts, epoch = restored_bit_equal("Ant", args, ckpt, ts, ANT_DR_EPOCHS)
        mass = "ant.rigid_body_properties.mass"
        if torch.equal(fts.env_state.dr[mass], st.dr[mass]):
            raise AssertionError("the restored run did not draw its own DR sample")
        played = train.main(["task=Ant", "task.randomize=True", "test=True", f"checkpoint={ckpt}"])
        print(f"Ant task.randomize=True restore: bit-equal (epoch {epoch}), DR sample drawn anew; "
              f"play: mean return {played:.2f}")
        if not np.isfinite(played):
            raise AssertionError("Ant play returned a non-finite mean return")
    return launches


def rows(t):
    return t.T.contiguous()


def xfrc_rows(x):
    n, nb, _ = x.shape
    return x.permute(2, 1, 0).reshape(6 * nb, n).contiguous()


def compare(env, steps: int, seed: int, qfrc_max: float = 3.0, with_xfrc: bool = True) -> dict:
    """Kernel vs plain version from the env's reset state under random qfrc
    (and xfrc); see `compare_model`."""
    m, n = env.model, env.num_envs
    state, _ = env.reset(seed)
    rng = np.random.RandomState(seed)
    cuda = lambda a: torch.tensor(a.astype(np.float32), device="cuda")
    qfrc = cuda(rng.uniform(-qfrc_max, qfrc_max, (n, m.nv)))
    xfrc = cuda(rng.uniform(-1, 1, (n, m.nbody, 6))) if with_xfrc else None
    return compare_model(m, env.sim_params, state.sim.q, state.sim.qd, qfrc, xfrc, None, steps)


def compare_model(m, p, q, qd, qfrc, xfrc, q_target, steps: int, tol=TOL, force_of=None, dyn=None) -> dict:
    """Kernel vs plain version from the same inputs, each step; the plain
    output carries the trajectory. Returns the max abs error per output;
    without contacts the force outputs must be exactly zero. With
    `force_of` (a body index, or a list of them) also returns, under
    "seen_force", the share of envs whose kernel body force on each of those
    bodies exceeded 1 mN at one step.
    With `dyn` (a `fused.PackedDyn` of per-env leaves) the kernel's first
    step must also differ from the kernel's step without them."""
    from isaacgymenvs_tpu_torch.engine import fused

    n = q.shape[0]
    s = fused._extract(m)
    names, dyn_rows = (dyn.names, dyn.rows) if dyn is not None else ((), None)
    plain = fused._step_math_torch(s, p, torch.device("cuda"), names)
    err = {k: 0.0 for k in tol}
    where = {}  # output -> (env, index) of its largest error
    pressed = torch.zeros(n, dtype=torch.bool, device="cuda")
    pressed_bodies = [force_of] if isinstance(force_of, int) else force_of
    if dyn is not None:
        with_leaves = fused.physics_step_fused(m, p, q, qd, qfrc, xfrc=xfrc, q_target=q_target, dyn=dyn)
        without = fused.physics_step_fused(m, p, q, qd, qfrc, xfrc=xfrc, q_target=q_target)
        gap = float((with_leaves.qd - without.qd).abs().max())
        if not gap > 1e-3:
            raise AssertionError(f"the kernel's step ignores its per-env leaves {names}: qd differs by {gap:.2e}")
    for _ in range(steps):
        ko = fused.physics_step_fused(m, p, q, qd, qfrc, xfrc=xfrc, q_target=q_target, dyn=dyn)
        po = plain(rows(q), rows(qd), rows(qfrc), None if xfrc is None else xfrc_rows(xfrc),
                   None if q_target is None else rows(q_target), dyn_rows)
        nb = m.nbody
        ref = {
            "q": po[0].T, "qd": po[1].T,
            "body_force": po[2].reshape(3, nb, n).permute(2, 1, 0),
            "body_torque": po[3].reshape(3, nb, n).permute(2, 1, 0),
            "dof_force": po[4].T,
        }
        for k in tol:
            got = getattr(ko, k)
            if not bool(torch.isfinite(got).all()):
                raise AssertionError(f"kernel output {k} is not finite")
            diff = (got - ref[k]).abs().reshape(n, -1)
            if float(diff.max()) > err[k]:
                err[k] = float(diff.max())
                where[k] = divmod(int(diff.argmax()), diff.shape[1])
            if s.nct == 0 and "force" in k and float(got.abs().max()) != 0.0:
                raise AssertionError(f"contact-free kernel wrote a non-zero {k}")
        if not float((ko.q - q).abs().max()) > 0.0:
            raise AssertionError("the step left q where it was")
        if force_of is not None:
            pressed |= (torch.linalg.vector_norm(ko.body_force[:, pressed_bodies], dim=-1) > 1e-3).all(dim=1)
        q, qd = ref["q"].contiguous(), ref["qd"].contiguous()
    torch.cuda.synchronize()
    bad = {k: (e, tol[k], where[k]) for k, e in err.items() if not e < tol[k]}
    if bad:
        raise AssertionError(f"kernel disagrees with the plain version at N={n} (error, tolerance, (env, index)): "
                             f"{bad}")
    if force_of is not None:
        err["seen_force"] = float(pressed.float().mean())
    return err


def event_ms(fn, reps: int) -> float:
    """Median ms of fn() over `reps` calls, each between two CUDA events."""
    times = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def kernel_device_ms(fn, reps: int = 20) -> float:
    """ms per launch of fn() with the launches queued back to back: large
    matrix products hold the device while the host enqueues all `reps`
    launches, so the two events bracket device time only (the kernel and
    the gap to the next one), not the wrapper's host side."""
    blocker = torch.randn(4096, 4096, device="cuda")
    n_block = 4
    while n_block <= 64:
        torch.cuda.synchronize()
        for _ in range(n_block):
            blocker @ blocker
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        queued_ahead = not a.query()  # the device had not reached the first launch yet
        b.synchronize()
        if queued_ahead:
            return a.elapsed_time(b) / reps
        n_block *= 2
    raise AssertionError("the host could not queue the launches ahead of the device")


def kernel_times(env, q, qd, qfrc, xfrc, name: str, reps: int = 50, qt=None, dyn=None, terr=None, wre=0,
                 sdf=None) -> dict:
    """ms per launch of the kernel (CUDA events around the wrapper, and
    queued back to back behind other device work), of its plain version,
    and its bound, at (rows, N) inputs on the card. `env` gives the model and
    the parameters (anything with `.model` and `.sim_params`); `dyn` is a
    `fused.PackedDyn` of per-env leaves, `terr` the packed terrain planes and
    `sdf` the packed SDF planes, whose rows count in the bytes bound; `wre`
    the warm-start reset period."""
    from isaacgymenvs_tpu_torch.engine import _cuda, fused

    s, p, n = fused._extract(env.model), env.sim_params, q.shape[-1]
    names, dr = (dyn.names, dyn.rows) if dyn is not None else ((), None)
    has_t = terr is not None
    _, step = fused._prepared(env.model, p, torch.device("cuda"), qt is not None, names, has_t)
    plain = fused._step_math_torch(s, p, torch.device("cuda"), names)
    call = lambda f: f(q, qd, qfrc, xfrc, qt, dr, terr, wre, sdf)
    for _ in range(3):
        call(step)
    ms = event_ms(lambda: call(step), reps)
    device_ms = kernel_device_ms(lambda: call(step))
    call(plain)
    plain_ms = event_ms(lambda: call(plain), PLAIN_REPS)
    flop_s, byte_s = peaks(name)
    flops = _cuda.kernel_flops(s, p, has_t) * n
    nbytes = _cuda.kernel_bytes(s, n, xfrc is not None, qt is not None, names, has_t)
    t_ops, t_bytes = 1e3 * flops / flop_s, 1e3 * nbytes / byte_s
    bound = max(t_ops, t_bytes)
    sizes = step.sizes
    print(f"fused step {'_'.join(map(str, sizes))} N={n}: {ms:.4f} ms/launch ({device_ms:.4f} ms on the device), "
          f"plain {plain_ms:.2f} ms, bound {bound:.6f} ms by operations ({flops / 1e9:.4f} GFLOP), {t_bytes:.6f} ms by bytes "
          f"({nbytes / 1e6:.4f} MB), {flops / (ms * 1e-3) / 1e12:.3f} TFLOP/s, {100 * bound / ms:.2f} % of the bound")
    occ = step.occupancy()
    figs = _cuda.ptxas_figures(_cuda.PTXAS_LOG.get(tuple(sizes), ""))
    return {"ms": ms, "device_ms": device_ms, "plain_ms": plain_ms, "bound_ms": bound,
            "bound_by": "operations" if t_ops >= t_bytes else "bytes", "envs_per_block": step.epb,
            "smem_bytes": step.smem_bytes, "blocks_per_sm": occ["blocks_per_sm"],
            "warps_per_sm": occ["blocks_per_sm"] * step.epb, "registers": figs["registers"],
            "spill_bytes": None if figs["spill_stores"] is None else figs["spill_stores"] + figs["spill_loads"]}


def time_case(key: str, card: str) -> dict:
    """`kernel_times` of a CASES entry at its full width, in a state where its rows act."""
    base, _, n = CASES[key]
    holder, names = case(key, n)
    q, qd, qfrc, xfrc, qt = contact_inputs(base, holder, n, seed=14, light="body_mass" in names)
    return kernel_times(holder, rows(q), rows(qd), rows(qfrc), None if xfrc is None else xfrc_rows(xfrc), card,
                        reps=30, qt=None if qt is None else rows(qt), dyn=packed_leaves(holder, names, n, seed=27))


def train_epochs(task: str = "Ant", width=(NUM_ENVS, HORIZON, 65536, 32768, 4), profile: bool = True,
                 overrides=(), recipe: str | None = None, timed: int = 1, check=None, warmup: bool = True) -> int:
    """`timed` timed PPO epochs after a warm-up on `task` at its yaml's full
    width (`width` = envs, horizon, batch, minibatch, mini-epochs), with the
    train yaml `recipe` (default <task>PPO; one with `network.rnn` trains
    with PPORecurrent, `algo.name=amp_continuous` with AMPAgent) and further
    config `overrides` (e.g.
    task.randomize=True); `check(agent, ts, traj)` sees each timed epoch's
    rollout; without `warmup` the first epoch is timed (its kernel built and
    loaded by an earlier phase). Returns the kernel launches of the timed
    epochs."""
    from isaacgymenvs_tpu_torch.engine import _cuda
    from isaacgymenvs_tpu_torch.learn import PPO, AMPAgent, PPORecurrent
    from isaacgymenvs_tpu_torch.tasks import task_map
    from isaacgymenvs_tpu_torch.utils.config import load_config

    cfg = load_config([f"task={task}", *([f"train={recipe}"] if recipe else []), *overrides])
    env = task_map[task](cfg["task"], device="cuda")
    label = task + (f" {recipe}" if recipe else "") + (" " + " ".join(overrides) if overrides else "")
    params = cfg["train"]["params"]
    kind = (AMPAgent if params.get("algo", {}).get("name") == "amp_continuous"
            else PPORecurrent if params.get("network", {}).get("rnn") else PPO)
    agent = kind(env, params, seed=int(cfg["seed"]))
    c = agent.cfg
    horizon = width[1]
    if (env.num_envs, c.horizon_length, agent.batch_size, agent.minibatch_size, c.mini_epochs) != tuple(width):
        raise AssertionError(f"{recipe or task + 'PPO'}.yaml is not at its full width")
    split = {}
    rollout = agent.rollout

    def timed_rollout(ts, noise=None):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = rollout(ts, noise)
        torch.cuda.synchronize()
        split["rollout"] = time.perf_counter() - t0
        split["traj"] = out[:2]
        return out

    agent.rollout = timed_rollout
    ts = agent.init()
    before = [p.detach().clone() for p in agent.network.parameters()]
    if warmup:
        ts, _ = agent.train_epoch(ts)
    total = 0
    for epoch in range(timed):
        torch.cuda.synchronize()
        _cuda.FusedStepCall.launches = 0
        t0 = time.perf_counter()
        ts, metrics = agent.train_epoch(ts)
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
        launches = _cuda.FusedStepCall.launches
        total += launches
        if launches != horizon * (1 if env.merge_slices else env.control_freq_inv):
            raise AssertionError(f"{launches} kernel launches in an epoch of {horizon} env steps")
        # the extremes of the episodes' reward terms are +-inf in an epoch where no episode ended
        bad = {k: v for k, v in metrics.items() if not np.isfinite(v)
               and not k.startswith(("episode_cumulative_min/", "episode_cumulative_max/"))}
        if bad or not c.min_lr <= metrics["lr"] <= c.max_lr or not metrics["kl"] >= 0.0:
            raise AssertionError(f"epoch metrics out of range: {metrics}")
        print(f"{label} train epoch {epoch}: {sec:.4f} s = rollout {split['rollout']:.4f} s + update "
              f"{sec - split['rollout']:.4f} s, {agent.batch_size / sec:.1f} env-steps/s, {launches} launches, "
              f"a_loss {metrics['a_loss']:.5f} c_loss {metrics['c_loss']:.5f} kl {metrics['kl']:.5f} "
              f"lr {metrics['lr']:.2e}" + "".join(f" {k} {metrics[k]:.5f}" for k in ("disc_acc", "disc_reward_mean")
                                                  if k in metrics))
        if check is not None:
            check(agent, *split["traj"])
    if profile:
        profile_window(lambda: agent.train_epoch(ts), f"{label} train epoch", 1, "epoch")
    moved = max(float((p.detach() - b).abs().max()) for p, b in zip(agent.network.parameters(), before))
    if not moved > 0.0 or not all(bool(torch.isfinite(p).all()) for p in agent.network.parameters()):
        raise AssertionError("the update did not move the parameters, or left them not finite")
    return total


def restored_bit_equal(task: str, args, ckpt: str, ts, epochs: int) -> list:
    """Restore `ckpt` into a fresh agent of another seed (PPORecurrent for a
    recipe with `network.rnn`): parameters (the central value net's too),
    lr, running stats, Adam moments and, where the env's
    `adr_load_from_checkpoint` gate is on, ADR's state must equal the
    trained state `ts` bit for bit. Returns [the
    fresh agent's train state, the checkpoint's epoch]."""
    from isaacgymenvs_tpu_torch.learn import PPO, PPORecurrent
    from isaacgymenvs_tpu_torch.tasks import task_map
    from isaacgymenvs_tpu_torch.utils.config import load_config

    cfg = load_config(args)
    params = cfg["train"].get("params", {})  # none where no recipe resolves (HumanoidAMPHands): PPO's defaults
    kind = PPORecurrent if params.get("network", {}).get("rnn") else PPO
    fresh = kind(task_map[task if task in task_map else cfg["task"]["name"]](cfg["task"], device="cuda"), params,
                 seed=1)
    fts, epoch = fresh.restore(ckpt, fresh.init())
    trained = ts.optimizer.param_groups[0]["params"]  # the trained network's parameters
    same = epoch == epochs and fts.lr == ts.lr
    same &= all(torch.equal(a, b) for (_, a), b in zip(fresh.named_trainables(), trained, strict=True))
    rms = [(fts.obs_rms, ts.obs_rms), (fts.value_rms, ts.value_rms)]
    if fresh.use_central_value:  # the asymmetric critic's states
        rms.append((fts.state_rms, ts.state_rms))
    if fresh.env.adr is not None and fresh.env.adr_load_from_checkpoint:  # ADR's state, under its gate
        same &= all(torch.equal(a, b) for a, b in zip(fts.env_state.adr.as_dict().values(),
                                                       ts.env_state.adr.as_dict().values()))
    for a, b in rms:
        same &= all(torch.equal(getattr(a, f), getattr(b, f)) for f in ("mean", "var", "count"))
    fst, tst = fts.optimizer.state_dict()["state"], ts.optimizer.state_dict()["state"]
    same &= set(fst) == set(tst) and all(
        torch.equal(fst[i][k].cpu(), tst[i][k].cpu()) for i in tst for k in ("step", "exp_avg", "exp_avg_sq"))
    if not same:
        raise AssertionError(f"{task}: restore did not give back the trained state bit for bit")
    return [fts, epoch]


def train_cartpole() -> int:
    """Cartpole through `train.main`: train, restore, play. Returns the
    kernel launches of the training run."""
    from isaacgymenvs_tpu_torch import train
    from isaacgymenvs_tpu_torch.engine import _cuda

    with tempfile.TemporaryDirectory() as runs:
        args = ["task=Cartpole", f"max_iterations={CARTPOLE_EPOCHS}", f"+train_dir={runs}"]
        torch.cuda.synchronize()
        _cuda.FusedStepCall.launches = 0
        t0 = time.perf_counter()
        ts, metrics = train.main(args)
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
        launches = _cuda.FusedStepCall.launches
        steps = CARTPOLE_EPOCHS * HORIZON
        if launches != steps or metrics["frames"] != steps * CARTPOLE_ENVS:
            raise AssertionError(f"{launches} launches, {metrics['frames']} frames for {steps} env steps")
        ret = metrics["mean_episode_return"]
        print(f"Cartpole train: {CARTPOLE_EPOCHS} epochs x {CARTPOLE_ENVS} envs in {sec:.2f} s "
              f"({metrics['frames'] / sec:.1f} env-steps/s with set-up), {launches} launches, "
              f"mean episode return {ret:.2f} (bar {RETURN_BAR})")
        if not ret > RETURN_BAR:
            raise AssertionError(f"Cartpole trained to {ret:.2f}, not past {RETURN_BAR}")
        ckpt = os.path.join(runs, "Cartpole", "nn", "last_Cartpole.pth")
        if not os.path.exists(os.path.join(runs, "Cartpole", "config.yaml")):
            raise AssertionError("train wrote no config.yaml")

        epoch = restored_bit_equal("Cartpole", args, ckpt, ts, CARTPOLE_EPOCHS).pop()

        played = train.main(["task=Cartpole", "test=True", f"checkpoint={ckpt}"])
        print(f"Cartpole restore: bit-equal (epoch {epoch}); play: mean return {played:.2f} (bar {RETURN_BAR})")
        if not played > RETURN_BAR:
            raise AssertionError(f"the restored policy played to {played:.2f}, not past {RETURN_BAR}")
    return launches


def profile_window(fn, label: str, units: int, unit: str) -> float:
    """Device busy share and the largest device-time entries of fn(), which
    covers `units` steps or epochs, from torch.profiler (CUDA activity).
    Returns the device ops per unit."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    ev = [e for e in prof.key_averages() if e.self_device_time_total > 0]
    busy_ms = sum(e.self_device_time_total for e in ev) / 1e3
    n_kernels = sum(e.count for e in ev if e.device_type == torch.autograd.DeviceType.CUDA)
    print(f"profile {label} x{units}: wall {wall_ms / units:.4f} ms/{unit} (profiler on), "
          f"device busy {busy_ms / units:.4f} ms/{unit} ({100 * busy_ms / wall_ms:.1f} %), "
          f"{n_kernels / units:.1f} device ops/{unit}")
    for e in sorted(ev, key=lambda e: -e.self_device_time_total)[:6]:
        print(f"  {e.self_device_time_total / 1e3 / units:.4f} ms/{unit}  x{e.count / units:.1f}  {e.key[:90]}")
    return n_kernels / units


def profile_env_step(env, steps: int = 2, label: str = "env.step") -> float:
    """env.step under random actions, profiled over `steps` steps after two
    unprofiled ones; returns device ops per step. Two steps by default: the
    profiler's processing costs about half a millisecond per recorded
    event, and a nut-bolt or IndustReal step records 5,600-41,700."""
    state, _ = env.reset(4)
    gen = torch.Generator(device="cuda").manual_seed(5)
    act = lambda: torch.rand(env.num_envs, env.num_acts, generator=gen, device="cuda") * 2 - 1
    for _ in range(2):
        state, _, _, _, _ = env.step(state, act())

    def window():
        st = state
        for _ in range(steps):
            st, _, _, _, _ = env.step(st, act())

    return profile_window(window, label, steps, "step")


# ---- Anymal and AnymalTerrain: top-K (K5), terrain rows (K6), merged windows ----

ANYMAL_ENVS = 4096  # numEnvs of both yamls
# instantiation key -> (task, config overrides)
ANYMAL_CASES = {
    "Anymal": ("Anymal", ()),
    "AnymalTerrain": ("AnymalTerrain", ()),
    "AnymalTerrain-plane": ("AnymalTerrain", ("task.env.terrain.terrainType=plane",)),
}
KEY_GAP = 1e-4  # the keys either side of the top-K cap differ by more, in every env and slice
MARGIN_GAP = 1e-5  # no candidate lies within this of the contact margin (its row would flip on rounding)
LIMIT_GAP = 1e-3  # nor a limited joint within this (radians) of a limit at the step's start or end
# A comparison env must be well conditioned: float32 rounding alone may move
# its step by a quarter of the tolerance at most. Measured as the plain
# version in float32, from the inputs and from the inputs with the base's
# position one ulp up and one ulp down, against the same in float64: the
# largest gap of the three stands for the rounding noise, as one float32
# result is only one draw of it (the same env moves by 0.01 N between a
# batch of 4096 envs and one of 8192, whose reductions sum otherwise).
# Not all are: a robot pushed in with 21 candidates active on flat ground
# carries 0.01-0.03 N of float32 noise in its forces, and far from the
# world origin the step's origin-referenced spatial algebra loses more (on
# the terrain grid, one ulp of a base's x at 150 m moves a step's qd by up
# to 0.1 m/s).
COND_TOL = {"q": 5e-5, "qd": 5e-4, "force": 5e-3}
# For the comparisons the terrain grid is moved so that the corner where
# four cells meet (rough slopes and stairs up, levels 4 and 5) lies at the
# world origin; the robots stand within CORNER_REACH of it.
TERRAIN_CORNER = (3, 4)  # (level, type) of the cell whose low corner it is
CORNER_REACH = 3.5
TUMBLED_SHARE = 16  # one comparison env in this many lies tumbled, more than 20 candidates active


def anymal_env(key: str, n: int, overrides=()):
    from isaacgymenvs_tpu_torch.tasks import task_map
    from isaacgymenvs_tpu_torch.utils.config import load_config

    task, extra = ANYMAL_CASES[key]
    return task_map[task](load_config([f"task={task}", f"num_envs={n}", *extra, *overrides])["task"], device="cuda")


def physics_args(env):
    """(params, warm_reset_every) of one env step's physics call."""
    return (env._merged_params, env._warm_reset_every) if env.merge_slices else (env.sim_params, 0)


def candidates_of(env, q):
    """World positions (N, ncp, 3) of the model's candidate points at q."""
    from isaacgymenvs_tpu_torch import maths
    from isaacgymenvs_tpu_torch.engine import dynamics

    m = env.model
    cb = torch.tensor(m.cpoint_body, device="cuda")
    kin = dynamics.forward_kinematics(m, q, torch.zeros(q.shape[0], m.nv, device="cuda"))
    return kin.x[:, cb] + maths.quat_rotate(kin.quat[:, cb], torch.tensor(np.asarray(m.cpoint_pos), device="cuda"))


def moved_terrain(env):
    """The env's terrain grid with TERRAIN_CORNER at the world origin."""
    from isaacgymenvs_tpu_torch.engine.dynamics import Terrain

    g = env.grid
    cells = round(g.env_length / g.hs)
    corner = [(g.border + TERRAIN_CORNER[k] * cells) * g.hs for k in range(2)]
    return Terrain(env.terrain.height, g.hs, origin=(-corner[0], -corner[1]))


def anymal_pool(env, n: int, seed: int, terrain):
    """2n comparison candidates (q, qd, q_target), env-leading on the card:
    robots standing (the lowest candidate 1 mm in the ground, default joint
    angles within 0.1 rad, random heading, gentle velocities), and one in
    four (four times the share taken) lying in a random orientation with
    random joints, pushed in until 21 candidates are within the margin (the
    poses whose 21 lowest candidates lie closest, from a pool of random ones)
    and moving up at a random share of the push-out speed of the deepest
    points (so that some of them end up with moderate contact forces)."""
    from isaacgymenvs_tpu_torch import maths

    m, dev = env.model, "cuda"
    g = torch.Generator(device=dev).manual_seed(seed)
    u = lambda *shape: torch.rand(*shape, generator=g, device=dev)
    k = 2 * n
    nt = k // 4
    reach = CORNER_REACH
    q = env.qpos0.repeat(k, 1)
    q[:, :2] = (2 * u(k, 2) - 1) * reach
    yaw = 2 * np.pi * u(k)
    q[:, 3:7] = torch.stack([torch.zeros_like(yaw)] * 2 + [torch.sin(yaw / 2), torch.cos(yaw / 2)], -1)
    q[:, env.dof_q_idx] = env.default_dof_pos + 0.2 * (u(k, 12) - 0.5)
    # the tumbled ones: the best of 8 random poses per slot
    wide = 8 * nt
    qt_ = q[:nt].repeat(8, 1)
    quat = torch.randn(wide, 4, generator=g, device=dev)
    qt_[:, 3:7] = quat / torch.linalg.vector_norm(quat, dim=1, keepdim=True)
    # random joints, the hips kept 0.09 rad inside their limits (+-0.49 on the inner side)
    qt_[:, env.dof_q_idx] = (2 * u(wide, 12) - 1) * torch.tensor([0.4, 3.0, 3.0] * 4, device=dev)
    x = candidates_of(env, qt_)
    ground = terrain.sample(x[..., :2]) if terrain is not None else 0.0
    gap = torch.sort(x[..., 2] - torch.tensor(np.asarray(m.cpoint_radius), device=dev) - ground, 1).values
    best = torch.argsort((gap[:, 20] - gap[:, 0]).reshape(8, nt), 0)[0] * nt + torch.arange(nt, device=dev)
    q[:nt] = qt_[best]
    x = candidates_of(env, q)
    ground = terrain.sample(x[..., :2]) if terrain is not None else 0.0
    gap = torch.sort(x[..., 2] - torch.tensor(np.asarray(m.cpoint_radius), device=dev) - ground, 1).values
    q[:nt, 2] -= gap[:nt, 20] - 0.015
    q[nt:, 2] -= gap[nt:, 0] + 0.001
    qd = 0.05 * (2 * u(k, m.nv) - 1)
    qd[:nt] = 0.0
    p, _ = physics_args(env)
    h = p.dt / (p.substeps * p.solver_iterations)
    deep = gap[:nt, 20] - gap[:nt, 0] - 0.015
    qd[:nt, 2] = u(nt) * torch.clamp(p.baumgarte_erp * deep / h, max=p.max_depenetration_velocity)
    qt = q + 0.1 * (u(k, m.nq) - 0.5)
    return q, qd, qt, nt


def conditioned(env, s, names, q, qd, qt, dyn_rows, terrain, p, wre, qfrc=None, xfrc=None, sdf=None,
                key_gap=KEY_GAP):
    """Per env: the cap-boundary keys of every slice differ by more than
    `key_gap` (KEY_GAP), no candidate lies within MARGIN_GAP of the margin, no joint
    crosses a limit during the step or lies within LIMIT_GAP of one at its
    start or end (a limit switches on a stiff spring, a jump the two
    roundings could take at different slices), and the plain step in
    float32, from q and from q's base position one ulp up and down, is
    within COND_TOL of the same in float64, as is the kernel's step from q
    of its step from q one ulp up (launches that count for no main path),
    all under the joint forces `qfrc` (N, nv; zero without), the body
    wrenches `xfrc` (N, nbody, 6) and the SDF planes `sdf` (`pack_sdf`)
    where given. Also returns the active candidates per env in the first
    slice."""
    from isaacgymenvs_tpu_torch.engine import fused

    keys = []
    terr = None if terrain is None else fused.pack_terrain(fused.terrain_dyn(env.model, terrain, q, qd))
    zero = torch.zeros(s.nv, q.shape[0], device="cuda") if qfrc is None else rows(qfrc)
    ins = (rows(q), rows(qd), zero, None if xfrc is None else xfrc_rows(xfrc), None if qt is None else rows(qt),
           dyn_rows, terr)
    a = fused._step_math_torch(s, p, torch.device("cuda"), names, keys)(*ins, wre, sdf)
    wide = fused._step_math_torch(s, p, torch.device("cuda"), names, dtype=torch.float64)
    b = wide(*(None if x is None else x.double() for x in ins), wre, None if sdf is None else sdf.double())
    plain = fused._step_math_torch(s, p, torch.device("cuda"), names)
    ok = torch.ones(q.shape[0], dtype=torch.bool, device="cuda")
    for sign in (0.0, 1e9, -1e9):
        if sign:
            shifted = q.clone()
            shifted[:, :3] = torch.nextafter(shifted[:, :3], torch.full_like(shifted[:, :3], sign))
            out = plain(rows(shifted), *ins[1:], wre, sdf)
        else:
            out = a
        gap = lambda i: (out[i] - b[i]).abs().amax(0)
        ok &= (gap(0) < COND_TOL["q"]) & (gap(1) < COND_TOL["qd"])
        ok &= (gap(2) < COND_TOL["force"]) & (gap(3) < COND_TOL["force"]) & (gap(4) < COND_TOL["force"])
    # and the kernel's own noise: its step from q and from q one ulp up
    dyn = None if dyn_rows is None else fused.PackedDyn(names, dyn_rows)
    run = lambda x: fused.physics_step_fused(env.model, p, x, qd, zero.T, xfrc=xfrc, q_target=qt, dyn=dyn,
                                             terrain=terr, warm_reset_every=wre, sdf=sdf)
    shifted = q.clone()
    shifted[:, :3] = torch.nextafter(shifted[:, :3], torch.full_like(shifted[:, :3], 1e9))
    k0, k1 = run(q), run(shifted)
    ok &= ((k0.q - k1.q).abs().amax(1) < COND_TOL["q"]) & ((k0.qd - k1.qd).abs().amax(1) < COND_TOL["qd"])
    for f in ("body_force", "body_torque", "dof_force"):
        d = (getattr(k0, f) - getattr(k1, f)).abs()
        ok &= d.reshape(d.shape[0], -1).amax(1) < COND_TOL["force"]
    m, dofs = env.model, env.dof_q_idx
    lim = torch.tensor(np.asarray(m.dof_limited)[env.dof_idx.cpu().numpy()], device="cuda") > 0
    lo = torch.tensor(np.asarray(m.dof_limit_lower)[env.dof_idx.cpu().numpy()], device="cuda")
    hi = torch.tensor(np.asarray(m.dof_limit_upper)[env.dof_idx.cpu().numpy()], device="cuda")
    start, end = q[:, dofs], a[0].T[:, dofs]
    near = lambda x: torch.minimum((x - lo).abs(), (x - hi).abs())
    crossed = ((start > hi) != (end > hi)) | ((start < lo) != (end < lo))
    ok &= ~torch.any(lim & (crossed | (near(start) < LIMIT_GAP) | (near(end) < LIMIT_GAP)), dim=1)
    cap = fused.topk_cap(s, p)
    for phi, key in keys:
        ok &= (phi + p.contact_margin).abs().amin(0) > MARGIN_GAP
        if cap:
            srt = torch.sort(key, 0, descending=True).values
            ok &= (srt[cap - 1] - srt[cap] > key_gap) | (srt[cap - 1] < -1e29)
    active = (keys[0][0] > -p.contact_margin).sum(0)
    return ok, active, terr


def anymal_inputs(key: str, env, n: int, seed: int):
    """Comparison inputs at n envs that pass `conditioned`: (q, qd, q_target,
    packed per-env leaves or None, terrain planes or None, the moved terrain
    or None), with the count of redrawn candidates and of envs past the cap."""
    from isaacgymenvs_tpu_torch.engine import fused

    s = fused._extract(env.model)
    p, wre = physics_args(env)
    terrain = moved_terrain(env) if env.terrain is not None else None
    q, qd, qt, nt = anymal_pool(env, n, seed, terrain)
    k = q.shape[0]
    names = env.randomizer.batched_leaf_names() if env.randomizer is not None else set()
    dyn = None
    if names:
        # per-env contact friction, as the setup-only draw gives it (factor 0.5-1.25)
        g = torch.Generator(device="cuda").manual_seed(seed + 1)
        fr = torch.tensor(np.asarray(env.model.cpoint_friction), device="cuda")
        dyn = fused.pack_dyn(s, {"cpoint_friction": fr * (0.5 + 0.75 * torch.rand(k, s.ncp_model, generator=g, device="cuda"))})
    ok, active, _ = conditioned(env, s, dyn.names if dyn is not None else (), q, qd, qt,
                                None if dyn is None else dyn.rows, terrain, p, wre)
    idx = torch.arange(k, device="cuda")
    tumbled = idx[ok & (idx < nt)][: n // TUMBLED_SHARE]
    standing = idx[ok & (idx >= nt)][: n - len(tumbled)]
    pick = torch.cat([tumbled, standing])
    if len(pick) != n or len(tumbled) == 0:
        raise AssertionError(f"{key}: only {len(pick)} of {k} candidates are well conditioned ({len(tumbled)} tumbled)")
    past_cap = int((active[pick] > 20).sum())
    sel = lambda t: t[pick].contiguous()
    dyn_n = None if dyn is None else fused.PackedDyn(dyn.names, dyn.rows[:, pick].contiguous())
    terr = None if terrain is None else fused.pack_terrain(fused.terrain_dyn(env.model, terrain, sel(q), sel(qd)))
    return (sel(q), sel(qd), sel(qt), dyn_n, terr, terrain), k - int(ok.sum()), past_cap


def compare_anymal(key: str) -> float:
    """The instantiation of `key` against its plain version for one env
    step's physics call (merged where the task merges) at N=1003 and at
    full width, in states where the rows act; returns the largest error."""
    from isaacgymenvs_tpu_torch.engine import fused

    worst = 0.0
    for n in (RAGGED_ENVS, ANYMAL_ENVS):
        env = anymal_env(key, n)
        (q, qd, qt, dyn, terr, _), redrawn, past_cap = anymal_inputs(key, env, n, seed=31)
        p, wre = physics_args(env)
        s = fused._extract(env.model)
        names = dyn.names if dyn is not None else ()
        zero = torch.zeros(n, s.nv, device="cuda")
        ko = fused.physics_step_fused(env.model, p, q, qd, zero, q_target=qt, dyn=dyn, warm_reset_every=wre,
                                      terrain=terr)
        plain = fused._step_math_torch(s, p, torch.device("cuda"), names)
        po = plain(rows(q), rows(qd), rows(zero), None, rows(qt), None if dyn is None else dyn.rows, terr, wre)
        nb = s.nbody
        ref = {"q": po[0].T, "qd": po[1].T, "body_force": po[2].reshape(3, nb, n).permute(2, 1, 0),
               "body_torque": po[3].reshape(3, nb, n).permute(2, 1, 0), "dof_force": po[4].T}
        err = {}
        for k_, ref_k in ref.items():
            got = getattr(ko, k_)
            if not bool(torch.isfinite(got).all()):
                raise AssertionError(f"{key}: kernel output {k_} is not finite")
            err[k_] = float((got - ref_k).abs().max())
        torch.cuda.synchronize()
        pressed = float((torch.linalg.vector_norm(ko.body_force, dim=-1).amax(1) > 1.0).float().mean())
        print(f"{key} kernel vs plain, N={n}, one env step ({p.substeps * p.solver_iterations} slices, "
              f"warm reset every {wre}), {redrawn} candidates redrawn, {past_cap} envs with more than 20 "
              f"candidates active, contact force in {100 * pressed:.1f} % of envs:", json.dumps(err))
        bad = {k_: (e, TOL[k_]) for k_, e in err.items() if not e < TOL[k_]}
        if bad or past_cap == 0 or pressed < 0.75:
            raise AssertionError(f"{key} kernel disagrees with the plain version at N={n}: {bad}, "
                                 f"{past_cap} envs past the cap, contact in {pressed:.3f}")
        worst = max(worst, *err.values())
    return worst


def merged_vs_separate() -> dict:
    """One merged call (4 slices, warm start reset at each slice) against four
    separate launches, from the same state: equal on flat ground (bar
    1e-6, expected 0); on terrain only printed (the planes are sampled once
    for the merged window, at each launch for the separate ones)."""
    from isaacgymenvs_tpu_torch.engine import fused

    out = {}
    for key in ("AnymalTerrain-plane", "AnymalTerrain"):
        env = anymal_env(key, ANYMAL_ENVS)
        (q, qd, qt, dyn, terr, terrain), _, _ = anymal_inputs(key, env, ANYMAL_ENVS, seed=32)
        zero = torch.zeros_like(qd)
        merged = fused.physics_step_fused(env.model, env._merged_params, q, qd, zero, q_target=qt, dyn=dyn,
                                          warm_reset_every=env._warm_reset_every, terrain=terr)
        qq, qv = q, qd
        for _ in range(env.control_freq_inv):
            planes = None if terrain is None else fused.pack_terrain(fused.terrain_dyn(env.model, terrain, qq, qv))
            sep = fused.physics_step_fused(env.model, env.sim_params, qq, qv, zero, q_target=qt, dyn=dyn,
                                           terrain=planes)
            qq, qv = sep.q, sep.qd
        d = {k: float((getattr(merged, k) - getattr(sep, k)).abs().max()) for k in ("q", "qd", "body_force")}
        print(f"{key}: merged window vs {env.control_freq_inv} separate launches, max |difference|:", json.dumps(d))
        if terrain is None and not max(d.values()) < 1e-6:
            raise AssertionError(f"the merged window differs from separate launches on flat ground: {d}")
        out[key] = d
    return out


def settle_anymal(steps: int = 30) -> None:
    """Anymal on flat ground from the default pose under zero actions (PD
    targets at the default joint angles): over the last 10 of `steps` steps
    the feet carry 0.9-1.3 x the weight on average, knees and base carry
    nothing, and the base's height changes by less than 3 cm. The base sinks
    slowly all the same: with the yaml's 16 APGD iterations the feet creep
    (PERF.md, section 6)."""
    from isaacgymenvs_tpu_torch.engine import fused

    env = anymal_env("Anymal", ANYMAL_ENVS)
    m, n = env.model, ANYMAL_ENVS
    state, _ = env.reset(11)
    state.sim.q[:, env.dof_q_idx] = env.default_dof_pos
    state.sim.qd.zero_()
    zero = torch.zeros(n, env.num_acts, device="cuda")
    shanks = [i for i, nm in enumerate(m.body_names) if "SHANK" in nm]
    z, fz, knees, base = [], [], 0.0, 0.0
    for i in range(steps):
        if i >= steps - 10:
            # the sensors of the step the env takes next, from the same state
            _, _, qt = env.compute_force(zero, state.sim.q, state.sim.qd, state.task)
            out = fused.physics_step_fused(m, env.sim_params, state.sim.q, state.sim.qd,
                                           torch.zeros(n, m.nv, device="cuda"), q_target=qt)
            fz.append(out.body_force[:, shanks, 2].sum(1).mean())
            knees = max(knees, float(torch.linalg.vector_norm(out.body_force[:, env.knee_bodies], dim=-1).max()))
            base = max(base, float(torch.linalg.vector_norm(out.body_force[:, 0], dim=-1).max()))
        state, obs, _, done, _ = env.step(state, zero)
        z.append(state.sim.q[:, 2].clone())
    ratio = float(torch.stack(fz).mean()) / (float(np.sum(m.body_mass)) * 9.81)
    zs = torch.stack(z[-10:])
    drift = float((zs.amax(0) - zs.amin(0)).max())
    print(f"settled Anymal ({steps} steps x {n} envs): feet fz / weight {ratio:.4f} (mean of the last 10 steps), "
          f"max knee force {knees:.3f} N, max base force {base:.3f} N, base z {float(z[-1].mean()):.4f} m "
          f"(from 0.62), largest change over the last 10 steps {drift:.4f} m, {int(done.sum())} envs done")
    if not 0.9 < ratio < 1.3 or knees > 1.0 or base > 1.0 or not drift < 0.03 or bool(done.any()):
        raise AssertionError("Anymal did not stand on flat ground")


def terrain_types_and_curriculum(steps: int = 100) -> None:
    """AnymalTerrain spawned on every terrain type at every level under random
    actions: finite, the base above the local ground after `steps` steps;
    then a run of 30-step episodes in which half the robots are moved a full
    cell away from their spawn: levels go up and down."""
    env = anymal_env("AnymalTerrain", ANYMAL_ENVS)
    state, _ = env.reset(12)
    n, dev = ANYMAL_ENVS, "cuda"
    level = torch.arange(n, device=dev) % env.num_levels
    ttype = (torch.arange(n, device=dev) // env.num_levels) % env.num_types
    q, qd, task = env.sample_init(state.rng, n, level=level, ttype=ttype)
    state.sim.q, state.sim.qd, state.task = q, qd, task
    gen = torch.Generator(device=dev).manual_seed(13)
    for _ in range(steps):
        state, obs, _, _, _ = env.step(state, torch.rand(n, env.num_acts, generator=gen, device=dev) * 2 - 1)
    q = state.sim.q
    above = q[:, 2] - env.terrain.sample(q[:, :2])
    types = len(torch.unique(state.task["type"]))
    print(f"AnymalTerrain on every terrain type ({types} types x {env.num_levels} levels, {steps} steps): finite "
          f"{bool(torch.isfinite(q).all() and torch.isfinite(obs).all())}, base above the local ground by "
          f"{float(above.min()):.4f} to {float(above.max()):.4f} m")
    if not bool(torch.isfinite(q).all()) or not float(above.min()) > 0.0 or types != env.num_types:
        raise AssertionError("AnymalTerrain left the terrain or went non-finite")
    cfg_env = anymal_env("AnymalTerrain", n, overrides=("task.env.episodeLength=30",))
    state, _ = cfg_env.reset(14)
    start = state.task["level"].clone()
    far = state.task["origin"][:, :2] + torch.tensor([cfg_env.grid.env_length, 0.0], device=dev)
    half = torch.arange(n, device=dev) < n // 2
    state.sim.q[:, :2] = torch.where(half[:, None], far, state.sim.q[:, :2])
    first = torch.full((n,), -1, dtype=torch.int64, device=dev)
    zero = torch.zeros(n, cfg_env.num_acts, device=dev)
    for _ in range(31):
        state, _, _, done, _ = cfg_env.step(state, zero)
        first = torch.where(done & (first < 0), state.task["level"], first)
    up = int((first > start).sum())
    down = int(((first >= 0) & (first < start)).sum())
    print(f"curriculum after one 30-step episode: {up} envs up a level, {down} down, "
          f"{int((first < 0).sum())} not finished")
    if not up > 0 or not down > 0:
        raise AssertionError("the terrain curriculum did not move both ways")


def train_anymal_terrain(epochs: int = 2) -> int:
    """`train.main task=AnymalTerrain` for `epochs` epochs at the yaml's width
    and a bit-equal restore into a fresh agent (the LSTM recipe of step 29
    plays). Returns the launches of the training run (one per env step: the
    merged window)."""
    from isaacgymenvs_tpu_torch import train
    from isaacgymenvs_tpu_torch.engine import _cuda

    with tempfile.TemporaryDirectory() as runs:
        args = ["task=AnymalTerrain", f"max_iterations={epochs}", f"+train_dir={runs}"]
        torch.cuda.synchronize()
        _cuda.FusedStepCall.launches = 0
        t0 = time.perf_counter()
        ts, metrics = train.main(args)
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
        launches = _cuda.FusedStepCall.launches
        steps = epochs * 24
        bad = {k: v for k, v in metrics.items() if not np.isfinite(v) and k != "mean_episode_return"}
        if launches != steps or metrics["frames"] != steps * ANYMAL_ENVS or bad:
            raise AssertionError(f"{launches} launches, {metrics['frames']} frames for {steps} env steps; {bad}")
        print(f"AnymalTerrain train: {epochs} epochs x {ANYMAL_ENVS} envs in {sec:.2f} s "
              f"({metrics['frames'] / sec:.1f} env-steps/s with set-up), {launches} launches, "
              f"mean terrain level {metrics['env/terrain_level']:.3f}")
        ckpt = os.path.join(runs, "AnymalTerrain", "nn", "last_AnymalTerrain.pth")
        epoch = restored_bit_equal("AnymalTerrain", args, ckpt, ts, epochs).pop()
        print(f"AnymalTerrain restore: bit-equal (epoch {epoch})")
    return launches


def drive_plane(steps: int = 16) -> int:
    """The top-K instantiation without terrain on its own path: AnymalTerrain
    with `terrainType: plane` stepped at full width under random actions."""
    from isaacgymenvs_tpu_torch.engine import _cuda

    env = anymal_env("AnymalTerrain-plane", ANYMAL_ENVS)
    state, _ = env.reset(15)
    gen = torch.Generator(device="cuda").manual_seed(16)
    torch.cuda.synchronize()
    _cuda.FusedStepCall.launches = 0
    for _ in range(steps):
        state, obs, _, _, _ = env.step(state, torch.rand(ANYMAL_ENVS, 12, generator=gen, device="cuda") * 2 - 1)
    torch.cuda.synchronize()
    launches = _cuda.FusedStepCall.launches
    print(f"AnymalTerrain terrainType=plane: {steps} env steps x {ANYMAL_ENVS} envs, {launches} launches")
    if launches != steps or not bool(torch.isfinite(obs).all()):
        raise AssertionError(f"plane variant: {launches} launches for {steps} steps, or observations not finite")
    return launches


def time_anymal(key: str, card: str) -> dict:
    """`kernel_times` of the instantiation of `key` at full width for one env
    step's physics call, in comparison states."""
    env = anymal_env(key, ANYMAL_ENVS)
    (q, qd, qt, dyn, terr, _), _, _ = anymal_inputs(key, env, ANYMAL_ENVS, seed=33)
    p, wre = physics_args(env)
    holder = type("Holder", (), {"model": env.model, "sim_params": p})()
    return kernel_times(holder, rows(q), rows(qd), rows(torch.zeros_like(qd)), None, card, reps=30,
                        qt=rows(qt), dyn=dyn, terr=terr, wre=wre)


# ---- FactoryTaskInsertion: K6 SDF rows, envs per block from shared memory ----

INSERTION_ENVS = 128  # numEnvs of FactoryTaskInsertion.yaml
INSERTION_WIDE = 4096
INSERTION_EPOCHS = 2
INSERTION_WIDTH = (INSERTION_ENVS, 32, 4096, 512, 8)  # envs, horizon, batch, minibatch, mini-epochs of its yaml
BALL_ENVS = 64  # balls settled on the SDF box side by side, each in its own env
BALL_REST = (0.45, 0.015)  # height of the ball's centre on the box top and the band it must rest in


def insertion_env(n: int):
    return task_env("FactoryTaskInsertion", n)


def ball_holder():
    """The ball on an SDF box (`model.examples.ball_on_sdf_box`) with the
    parameters of tests/test_sdf.py, as an object with `.model` and `.sim_params`."""
    from types import SimpleNamespace

    from isaacgymenvs_tpu_torch.engine.dynamics import SimParams
    from isaacgymenvs_tpu_torch.model.examples import ball_on_sdf_box

    return SimpleNamespace(model=ball_on_sdf_box(), use_pd_targets=False, sim_params=SimParams(dt=1 / 60, substeps=2))


def sdf_planes(m, q, qd):
    from isaacgymenvs_tpu_torch.engine import fused

    return fused.pack_sdf(fused.sdf_dyn(m, q, qd))


def insertion_inputs(env, n: int, seed: int):
    """n comparison inputs of Insertion's physics step on the card: contact
    states (`FactoryTaskInsertion.contact_states`: the plug in the bore, on
    the socket's top face, lying against its side), 2n drawn and the first n
    kept whose rows are well placed for the comparison: no candidate within
    MARGIN_GAP of the contact margin and, in every slice, the keys either
    side of the top-K cap more than KEY_GAP apart (or no active row past the
    cap). Returns ((q, qd, qfrc, xfrc, q_target, SDF planes), redrawn, envs
    past the cap, share of envs with an SDF row active)."""
    from isaacgymenvs_tpu_torch.engine import fused

    m, p = env.model, env.sim_params
    s = fused._extract(m)
    cap = fused.topk_cap(s, p)
    q, qd = env.contact_states(2 * n, seed)
    qfrc, xfrc, qt = env.compute_force(None, q, qd, {"q_ref": q[:, env.q_idx]})
    sdf = sdf_planes(m, q, qd)
    keys = []
    fused._step_math_torch(s, p, torch.device("cuda"), (), keys)(
        rows(q), rows(qd), rows(qfrc), xfrc_rows(xfrc), rows(qt), None, None, 0, sdf)
    ok = torch.ones(2 * n, dtype=torch.bool, device="cuda")
    for phi, key in keys:
        ok &= (phi + p.contact_margin).abs().amin(0) > MARGIN_GAP
        srt = torch.sort(key, 0, descending=True).values
        ok &= (srt[cap - 1] - srt[cap] > KEY_GAP) | (srt[cap] < -1e29)
    active = keys[0][0] > -p.contact_margin
    pick = torch.arange(2 * n, device="cuda")[ok][:n]
    if len(pick) != n:
        raise AssertionError(f"Insertion: only {len(pick)} of {2 * n} contact states are well placed")
    past_cap = int((active.sum(0)[pick] > cap).sum())
    sdf_share = float(active[s.nc + s.pp_nc:s.nc + s.pp_nc + s.sp_n].any(0)[pick].float().mean())
    sel = lambda t: t[pick].contiguous()
    return ((sel(q), sel(qd), sel(qfrc), sel(xfrc), sel(qt), sdf[:, pick].contiguous()),
            2 * n - int(ok.sum()), past_cap, sdf_share)


def compare_outputs(label: str, ko, po, nb: int, n: int) -> dict:
    """Max abs error per output of the kernel's FusedOut against the plain
    version's (rows, N) outputs; raises past TOL."""
    ref = {"q": po[0].T, "qd": po[1].T, "body_force": po[2].reshape(3, nb, n).permute(2, 1, 0),
           "body_torque": po[3].reshape(3, nb, n).permute(2, 1, 0), "dof_force": po[4].T}
    err = {}
    for k, r in ref.items():
        got = getattr(ko, k)
        if not bool(torch.isfinite(got).all()):
            raise AssertionError(f"{label}: kernel output {k} is not finite")
        err[k] = float((got - r).abs().max())
    bad = {k: (e, TOL[k]) for k, e in err.items() if not e < TOL[k]}
    if bad:
        raise AssertionError(f"{label}: kernel disagrees with the plain version: {bad}")
    return err


def compare_insertion() -> float:
    """Insertion's instantiation (64 plane rows, 64 SDF rows, cap 32,
    q_target, xfrc; envs per block from shared memory) against its plain
    version for one env step at N=RAGGED_ENVS, at the yaml's 128 and at
    4096, in contact states with SDF rows active in most envs and the cap
    binding in some; returns the largest error."""
    from isaacgymenvs_tpu_torch.engine import fused

    worst = 0.0
    for n in (RAGGED_ENVS, INSERTION_ENVS, INSERTION_WIDE):
        env = insertion_env(n)
        (q, qd, qfrc, xfrc, qt, sdf), redrawn, past_cap, sdf_share = insertion_inputs(env, n, seed=41)
        m, p = env.model, env.sim_params
        s = fused._extract(m)
        ko = fused.physics_step_fused(m, p, q, qd, qfrc, xfrc=xfrc, q_target=qt, sdf=sdf)
        po = fused._step_math_torch(s, p, torch.device("cuda"))(
            rows(q), rows(qd), rows(qfrc), xfrc_rows(xfrc), rows(qt), None, None, 0, sdf)
        err = compare_outputs(f"Insertion N={n}", ko, po, s.nbody, n)
        torch.cuda.synchronize()
        plug = env.plug_ref.body0
        pressed = float((torch.linalg.vector_norm(ko.body_force[:, plug], dim=-1) > 0.1).float().mean())
        _, step = fused._prepared(m, p, q.device, True)
        print(f"Insertion kernel vs plain, N={n}, one env step ({p.substeps} slices), {step.epb} envs per block "
              f"({step.smem_bytes} bytes of shared memory, limit {step.smem_limit}), {redrawn} states redrawn, "
              f"SDF rows active in {100 * sdf_share:.1f} % of envs, {past_cap} envs past the cap of "
              f"{fused.topk_cap(s, p)}, plug force in {100 * pressed:.1f} % of envs:", json.dumps(err))
        if not sdf_share > 0.5 or past_cap == 0 or not pressed > 0.5:
            raise AssertionError(f"Insertion N={n}: SDF rows active in {sdf_share:.3f} of envs, {past_cap} past "
                                 f"the cap, plug force in {pressed:.3f}")
        worst = max(worst, *err.values())
    return worst


def ball_states(n: int, seed: int):
    """Balls over the SDF box: resting on its top (0-1 mm in), pressed in
    1 mm, or 10 cm above it, x and y within the top face, gentle spin."""
    m = ball_holder().model
    rng = np.random.RandomState(seed)
    q = np.tile(np.asarray(m.qpos0, np.float32), (n, 1))
    q[:, 0:2] = rng.uniform(-0.15, 0.15, (n, 2))
    q[:, 2] = np.where(np.arange(n) % 4 == 3, 0.55, 0.449 + rng.uniform(0.0, 1e-3, n))
    qd = np.zeros((n, m.nv), np.float32)
    qd[:, 3:] = rng.uniform(-0.2, 0.2, (n, 3))
    cuda = lambda a: torch.tensor(a, device="cuda")
    return cuda(q), cuda(qd)


def compare_ball() -> float:
    """The ball-on-box instantiation (one plane row, one SDF row, no cap)
    against its plain version at N=RAGGED_ENVS for 3 steps, the planes
    sampled at each step's entry pose; the box takes force in the envs whose
    ball rests on it. Returns the largest error."""
    from isaacgymenvs_tpu_torch.engine import fused

    h = ball_holder()
    m, p, n = h.model, h.sim_params, RAGGED_ENVS
    s = fused._extract(m)
    plain = fused._step_math_torch(s, p, torch.device("cuda"))
    q, qd = ball_states(n, seed=42)
    zero = torch.zeros(n, m.nv, device="cuda")
    worst, pressed = 0.0, None
    for _ in range(3):
        sdf = sdf_planes(m, q, qd)
        ko = fused.physics_step_fused(m, p, q, qd, zero, sdf=sdf)
        po = plain(rows(q), rows(qd), rows(zero), None, None, None, None, 0, sdf)
        err = compare_outputs(f"ball on SDF box N={n}", ko, po, s.nbody, n)
        worst = max(worst, *err.values())
        if pressed is None:
            pressed = float((ko.body_force[:, 1, 2].abs() > 1.0).float().mean())
        q, qd = po[0].T.contiguous(), po[1].T.contiguous()
    print(f"ball on SDF box kernel vs plain, N={n}, 3 steps: max error {worst:.3e}, box force in "
          f"{100 * pressed:.1f} % of envs")
    if not pressed > 0.5:
        raise AssertionError(f"the SDF row acted in {pressed:.3f} of the ball envs")
    return worst


def settle_ball(steps: int = 150) -> int:
    """BALL_ENVS balls dropped from 0.5 m at x, y within the box top, through
    `physics_step_fused` with the planes sampled at each step's entry pose:
    each rests at BALL_REST (tests/test_sdf.py test_ball_rests_on_sdf_box)
    with |qd_z| < 0.05. Returns the launches."""
    from isaacgymenvs_tpu_torch.engine import _cuda, fused

    h = ball_holder()
    m, p, n = h.model, h.sim_params, BALL_ENVS
    q = torch.tensor(np.asarray(m.qpos0, np.float32), device="cuda").repeat(n, 1)
    q[:, 0:2] = torch.tensor(np.random.RandomState(43).uniform(-0.15, 0.15, (n, 2)).astype(np.float32), device="cuda")
    qd = torch.zeros(n, m.nv, device="cuda")
    zero = torch.zeros_like(qd)
    torch.cuda.synchronize()
    _cuda.FusedStepCall.launches = 0
    for _ in range(steps):
        out = fused.physics_step_fused(m, p, q, qd, zero, sdf=sdf_planes(m, q, qd))
        q, qd = out.q, out.qd
    torch.cuda.synchronize()
    launches = _cuda.FusedStepCall.launches
    z, vz = q[:, 2], qd[:, 2]
    print(f"ball on SDF box: {steps} steps x {n} balls, {launches} launches, rest height "
          f"{float(z.min()):.5f}-{float(z.max()):.5f} m (bar {BALL_REST[0]} +- {BALL_REST[1]}), "
          f"max |qd_z| {float(vz.abs().max()):.5f}")
    if launches != steps or not bool(torch.isfinite(q).all()) or not float((z - BALL_REST[0]).abs().max()) < BALL_REST[1] \
            or not float(vz.abs().max()) < 0.05:
        raise AssertionError("the ball did not come to rest on the SDF box")
    return launches


def train_insertion(epochs: int = INSERTION_EPOCHS) -> int:
    """`train.main task=FactoryTaskInsertion` at the yaml's 128 envs for
    `epochs` epochs, a bit-equal restore into a fresh agent, and play (32
    episodes, cut to 64 steps: the yaml's 1024 take some 40 s at 30-40 ms per
    host-bound env step). Returns the training run's launches."""
    from isaacgymenvs_tpu_torch import train
    from isaacgymenvs_tpu_torch.engine import _cuda

    with tempfile.TemporaryDirectory() as runs:
        args = ["task=FactoryTaskInsertion", f"max_iterations={epochs}", f"+train_dir={runs}"]
        torch.cuda.synchronize()
        _cuda.FusedStepCall.launches = 0
        t0 = time.perf_counter()
        ts, metrics = train.main(args)
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
        launches = _cuda.FusedStepCall.launches
        steps = epochs * INSERTION_WIDTH[1]
        bad = {k: v for k, v in metrics.items() if not np.isfinite(v) and k != "mean_episode_return"}
        if launches != steps or metrics["frames"] != steps * INSERTION_ENVS or bad:
            raise AssertionError(f"{launches} launches, {metrics['frames']} frames for {steps} env steps; {bad}")
        print(f"FactoryTaskInsertion train: {epochs} epochs x {INSERTION_ENVS} envs in {sec:.2f} s "
              f"({metrics['frames'] / sec:.1f} env-steps/s with set-up), {launches} launches")
        ckpt = os.path.join(runs, "FactoryTaskInsertion", "nn", "last_FactoryTaskInsertion.pth")
        epoch = restored_bit_equal("FactoryTaskInsertion", args, ckpt, ts, epochs).pop()
        t0 = time.perf_counter()
        played = train.main(["task=FactoryTaskInsertion", "test=True", f"checkpoint={ckpt}",
                             "task.env.episodeLength=64"])
        print(f"FactoryTaskInsertion restore: bit-equal (epoch {epoch}); play: mean return {played:.2f} in "
              f"{time.perf_counter() - t0:.2f} s")
        if played != 0.0:
            raise AssertionError(f"the template's return is zero, play gave {played}")
    return launches


def time_insertion(card: str) -> dict:
    """`kernel_times` of Insertion's instantiation at the yaml's 128 envs and
    at 4096, in comparison states; the 4096 figures under `<key>_4096`."""
    out = {}
    for n in (INSERTION_ENVS, INSERTION_WIDE):
        env = insertion_env(n)
        (q, qd, qfrc, xfrc, qt, sdf), _, _, _ = insertion_inputs(env, n, seed=44)
        t = kernel_times(env, rows(q), rows(qd), rows(qfrc), xfrc_rows(xfrc), card, reps=30, qt=rows(qt), sdf=sdf)
        out.update(t if n == INSERTION_ENVS else {f"{k}_{n}": v for k, v in t.items() if k != "bound_by"})
    return out


def time_ball(card: str) -> dict:
    """`kernel_times` of the ball-on-box instantiation at 4096 envs, balls on the box."""
    h = ball_holder()
    q, qd = ball_states(NUM_ENVS, seed=45)
    zero = torch.zeros_like(qd)
    return kernel_times(h, rows(q), rows(qd), rows(zero), None, card, reps=30, sdf=sdf_planes(h.model, q, qd))


# ---- Humanoid (nv 27 on K1 + K2), SAC, recurrent PPO, determinism ----------

HUMANOID_ENVS = 4096  # numEnvs of Humanoid.yaml
HUMANOID_POOL = 8192  # comparison states are drawn this many at a time (`humanoid_inputs`)


def humanoid_env(n: int):
    return task_env("Humanoid", n)


def humanoid_states(env, n: int, seed: int):
    """Both feet on the ground (`Humanoid.standing_states`), motors at up to
    0.02 of their gear (at 0.3 a foot lifts in the first step in a quarter
    of the envs), no body wrench: (q, qd, qfrc, xfrc)."""
    q, qd = env.standing_states(n, seed)
    rng = np.random.RandomState(seed + 1)
    act = torch.tensor(rng.uniform(-0.02, 0.02, (n, env.num_acts)).astype(np.float32), device="cuda")
    return q, qd, env.qfrc_from_actuators(act), torch.zeros(n, env.model.nbody, 6, device="cuda")


def humanoid_inputs(env, n: int, seed: int, steps: int):
    """`humanoid_states` kept where rounding alone moves `steps` steps by at
    most COND_TOL: the plain version in float32 against the same in
    float64, and the kernel's step from q against its step from q with the
    base's position one ulp up (launches that count for no main path). A
    standing humanoid's foot forces carry up to 0.1 N of float32 noise under
    16 APGD iterations, whose restarts and cone projections flip on
    rounding; without the filter 2-14 of 8192 envs per step pass the
    tolerance, by up to 0.063 N (PERF.md section 6). No joint crosses a limit in the step or lies
    within LIMIT_GAP of one at its start or end. Drawn in pools of HUMANOID_POOL states until n
    are kept; returns the inputs and the share kept."""
    from isaacgymenvs_tpu_torch.engine import fused

    m, p = env.model, env.sim_params
    s = fused._extract(m)
    narrow = fused._step_math_torch(s, p, torch.device("cuda"))
    wide = fused._step_math_torch(s, p, torch.device("cuda"), dtype=torch.float64)
    dofs, d = env.dof_q_idx, env.dof_idx.cpu().numpy()
    lo, hi = (torch.tensor(np.asarray(a)[d], device="cuda") for a in (m.dof_limit_lower, m.dof_limit_upper))
    kept, drawn = [], 0
    for k in range(64):
        q, qd, qfrc, xfrc = humanoid_states(env, HUMANOID_POOL, seed + 7919 * k)
        fixed = (rows(qfrc), xfrc_rows(xfrc))
        ok = torch.ones(HUMANOID_POOL, dtype=torch.bool, device="cuda")
        x = (q, qd)
        for _ in range(steps):
            a = narrow(rows(x[0]), rows(x[1]), *fixed)
            b = wide(*(t.double() for t in (rows(x[0]), rows(x[1]), *fixed)))
            gap = lambda i: (a[i] - b[i]).abs().amax(0)
            ok &= (gap(0) < COND_TOL["q"]) & (gap(1) < COND_TOL["qd"])
            ok &= (gap(2) < COND_TOL["force"]) & (gap(3) < COND_TOL["force"]) & (gap(4) < COND_TOL["force"])
            shifted = x[0].clone()
            shifted[:, :3] = torch.nextafter(shifted[:, :3], torch.full_like(shifted[:, :3], 1e9))
            k0, k1 = (fused.physics_step_fused(m, p, y, x[1], qfrc, xfrc=xfrc) for y in (x[0], shifted))
            ok &= ((k0.q - k1.q).abs().amax(1) < COND_TOL["q"]) & ((k0.qd - k1.qd).abs().amax(1) < COND_TOL["qd"])
            for f in ("body_force", "body_torque", "dof_force"):
                d = (getattr(k0, f) - getattr(k1, f)).abs()
                ok &= d.reshape(d.shape[0], -1).amax(1) < COND_TOL["force"]
            # no limited joint crosses a limit or lies within LIMIT_GAP of one at the step's start or end
            start, end = x[0][:, dofs], a[0].T[:, dofs]
            near = lambda y: torch.minimum((y - lo).abs(), (y - hi).abs())
            crossed = ((start > hi) != (end > hi)) | ((start < lo) != (end < lo))
            ok &= ~torch.any(crossed | (near(start) < LIMIT_GAP) | (near(end) < LIMIT_GAP), dim=1)
            x = (a[0].T.contiguous(), a[1].T.contiguous())
        kept.append(tuple(t[ok] for t in (q, qd, qfrc, xfrc)))
        drawn += HUMANOID_POOL
        if sum(len(c[0]) for c in kept) >= n:
            break
    have = sum(len(c[0]) for c in kept)
    if have < n:
        raise AssertionError(f"Humanoid: {have} of {drawn} states are well conditioned, {n} needed")
    return tuple(torch.cat(t)[:n].contiguous() for t in zip(*kept)), have / drawn


def compare_humanoid() -> float:
    """The Humanoid instantiation (nv 27, 35 plane contacts, no cap) against
    its plain version at N=RAGGED_ENVS for 3 steps and at full width for one,
    from well-conditioned states with both feet on the ground; both feet
    take force in 90 % of the envs or more. Returns the largest error."""
    worst = 0.0
    for n, steps in ((RAGGED_ENVS, 3), (HUMANOID_ENVS, 1)):
        env = humanoid_env(n)
        (q, qd, qfrc, xfrc), kept = humanoid_inputs(env, n, seed=51, steps=steps)
        err = compare_model(env.model, env.sim_params, q, qd, qfrc, xfrc, None, steps, force_of=env.feet.tolist())
        seen = err.pop("seen_force")
        print(f"Humanoid kernel vs plain, N={n}, {steps} step(s), {100 * kept:.1f} % of the drawn states well conditioned, "
              f"both feet pressed in {100 * seen:.1f} % of envs:", json.dumps(err))
        if not seen > 0.9:
            raise AssertionError(f"Humanoid N={n}: both feet took force in {seen:.3f} of the envs")
        worst = max(worst, *err.values())
    return worst


def time_humanoid(card: str) -> dict:
    """`kernel_times` of the Humanoid instantiation at full width, feet on the ground."""
    env = humanoid_env(HUMANOID_ENVS)
    q, qd, qfrc, xfrc = humanoid_states(env, HUMANOID_ENVS, seed=53)
    return kernel_times(env, rows(q), rows(qd), rows(qfrc), xfrc_rows(xfrc), card, reps=30)


HUMANOID_WIDTH = (HUMANOID_ENVS, 32, 131072, 32768, 5)  # envs, horizon, batch, minibatch, mini-epochs
LSTM_WIDTH = (4096, 24, 98304, 16384, 5)  # AnymalTerrainPPO_LSTM.yaml: 24,576 windows of 4, 4,096 per minibatch


def train_humanoid_sac() -> int:
    """HumanoidSAC.yaml at Humanoid.yaml's 4096 envs (batch 4,096, 8 env
    steps per epoch, a buffer of 1,000,000): epochs up to and past the
    warm-up, then two timed ones (8 launches each, the buffer at steps x
    4096, alpha > 0, finite losses); the actor and critics moved, and one
    more update moves the targets by tau; a save/restore round trip into a
    fresh agent is bit-equal in every saved leaf; `test=True` plays the
    checkpoint to a finite return. Returns the timed epochs' launches."""
    from isaacgymenvs_tpu_torch import train
    from isaacgymenvs_tpu_torch.engine import _cuda
    from isaacgymenvs_tpu_torch.learn import SAC
    from isaacgymenvs_tpu_torch.tasks import task_map
    from isaacgymenvs_tpu_torch.utils.config import load_config

    args = ["task=Humanoid", "train=HumanoidSAC"]
    cfg = load_config(args)
    params = cfg["train"]["params"]
    agent = SAC(task_map["Humanoid"](cfg["task"], device="cuda"), params, seed=int(cfg["seed"]))
    c, n = agent.cfg, agent.env.num_envs
    ts = agent.init()
    if (n, c.batch_size, c.num_steps_per_episode, ts.buffer.capacity) != (HUMANOID_ENVS, 4096, 8, 1_000_000):
        raise AssertionError("HumanoidSAC.yaml is not at its full width")
    nets = lambda: [[p.detach().clone() for p in m.parameters()] for m in (agent.actor, agent.critic)]
    before = nets()
    while ts.total_steps <= c.num_warmup_steps:
        ts, _ = agent.train_epoch(ts)
    total = 0
    for epoch in range(2):
        torch.cuda.synchronize()
        _cuda.FusedStepCall.launches = 0
        t0 = time.perf_counter()
        ts, m = agent.train_epoch(ts)
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
        launches = _cuda.FusedStepCall.launches
        total += launches
        stored = min(ts.total_steps * n, ts.buffer.capacity)
        if launches != c.num_steps_per_episode or ts.buffer.size != stored:
            raise AssertionError(f"{launches} launches in an epoch of 8 env steps, buffer at {ts.buffer.size}")
        if not all(np.isfinite(m[k]) for k in ("c_loss", "a_loss", "alpha")) or not m["alpha"] > 0:
            raise AssertionError(f"SAC epoch metrics out of range: {m}")
        print(f"Humanoid SAC train epoch {epoch}: {sec:.4f} s, {c.num_steps_per_episode * n / sec:.1f} env-steps/s "
              f"(8 env steps and 8 updates of batch {c.batch_size}), {launches} launches, buffer {ts.buffer.size}, "
              f"c_loss {m['c_loss']:.4f} a_loss {m['a_loss']:.4f} alpha {m['alpha']:.4f}")
    if not all(any(not torch.equal(a, b) for a, b in zip(x, y)) for x, y in zip(before, nets())):
        raise AssertionError("the actor or the critics did not move")
    old = [p.detach().clone() for p in agent.target.parameters()]
    agent._update(ts)
    tau = c.critic_tau
    if not all(torch.equal(t, (1.0 - tau) * o + tau * k.detach())
               for t, o, k in zip(agent.target.parameters(), old, agent.critic.parameters())):
        raise AssertionError("the targets did not move by tau towards the critics")
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "HumanoidSAC.pth")
        agent.save(path, ts)
        fresh = SAC(task_map["Humanoid"](cfg["task"], device="cuda"), params, seed=1)
        fts = fresh.restore(path, fresh.init())
        same = all(torch.equal(a, b) for x, y in ((agent.actor, fresh.actor), (agent.critic, fresh.critic),
                                                  (agent.target, fresh.target))
                   for a, b in zip(x.state_dict().values(), y.state_dict().values(), strict=True))
        same &= torch.equal(agent.log_alpha, fresh.log_alpha)
        same &= all(torch.equal(getattr(ts.obs_rms, f), getattr(fts.obs_rms, f)) for f in ("mean", "var", "count"))
        if not same:
            raise AssertionError("Humanoid SAC: restore did not give back the saved leaves bit for bit")
        del fresh, fts
        played = train.main([*args, "test=True", f"checkpoint={path}"])
    print(f"Humanoid SAC restore: bit-equal; play: mean return {played:.2f}")
    if not np.isfinite(played):
        raise AssertionError(f"Humanoid SAC played to {played}")
    return total


# the recipes this port added, as `train` runs them: (config selection, run
# name, checkpoint file, play overrides that cut the episodes)
RECIPES = {
    "Humanoid": (["task=Humanoid"], "Humanoid", "last_Humanoid.pth", []),
    "HumanoidSAC": (["task=Humanoid", "train=HumanoidSAC"], "HumanoidSAC", "HumanoidSAC.pth", []),
    "AntSAC": (["task=Ant", "train=AntSAC"], "AntSAC", "AntSAC.pth", ["task.env.episodeLength=100"]),
    "AnymalTerrainPPO_LSTM": (["task=AnymalTerrain", "train=AnymalTerrainPPO_LSTM"], "AnymalTerrainLSTM",
                              "last_AnymalTerrainLSTM.pth", ["task.env.learn.episodeLength_s=2"]),
}
RECIPE_EPOCHS = 2  # SAC's 16 env steps reach its updates (from the 11th on)
# the recipes resumed and played: one per learner (feed-forward PPO, SAC, the LSTM); HumanoidSAC's checkpoint is
# restored bit for bit and played in step 28
RESUMED = ("Humanoid", "AntSAC", "AnymalTerrainPPO_LSTM")


def train_main_recipes() -> dict:
    """Each recipe of RECIPES through `train.main` in-process at its yaml's
    width, into a temporary run directory: RECIPE_EPOCHS epochs (one launch
    per env step, finite metrics, SAC's critic loss > 0); for those of
    RESUMED a resume from the checkpoint for one more epoch, and `test=True`
    play of it (episodes cut where the yaml's would take minutes). Returns
    the training launches per recipe."""
    from isaacgymenvs_tpu_torch import train
    from isaacgymenvs_tpu_torch.engine import _cuda

    launches = {}
    for key, (select, name, ckpt, play_cut) in RECIPES.items():
        with tempfile.TemporaryDirectory() as runs:
            args = [*select, f"+train_dir={runs}"]
            torch.cuda.synchronize()
            _cuda.FusedStepCall.launches = 0
            t0 = time.perf_counter()
            _, metrics = train.main([*args, f"max_iterations={RECIPE_EPOCHS}"])
            torch.cuda.synchronize()
            sec = time.perf_counter() - t0
            launches[key] = _cuda.FusedStepCall.launches
            env_steps = metrics["frames"] // NUM_ENVS  # every recipe runs its yaml's 4096 envs
            bad = {k: v for k, v in metrics.items() if isinstance(v, float) and not np.isfinite(v)
                   and k != "mean_episode_return"}
            sac = "SAC" in key
            if launches[key] != env_steps or metrics["epoch"] != RECIPE_EPOCHS or bad \
                    or (sac and not metrics["c_loss"] > 0):
                raise AssertionError(f"{key}: {launches[key]} launches for {metrics['frames']} frames, {metrics}")
            path = os.path.join(runs, name, "nn", ckpt)
            if key not in RESUMED:
                print(f"train.main {' '.join(select)}: {RECIPE_EPOCHS} epochs x {NUM_ENVS} envs in {sec:.2f} s "
                      f"({metrics['frames'] / sec:.1f} env-steps/s with set-up), {launches[key]} launches")
                continue
            _, resumed = train.main([*args, f"max_iterations={1 if sac else RECIPE_EPOCHS + 1}", f"checkpoint={path}"])
            played = train.main([*args, "test=True", f"checkpoint={path}", *play_cut])
        print(f"train.main {' '.join(select)}: {RECIPE_EPOCHS} epochs x {NUM_ENVS} envs in {sec:.2f} s "
              f"({metrics['frames'] / sec:.1f} env-steps/s with set-up), {launches[key]} launches; resumed to "
              f"epoch {resumed['epoch']}; played mean return {played:.2f}")
        if not resumed["epoch"] == (1 if sac else RECIPE_EPOCHS + 1) or not np.isfinite(played):
            raise AssertionError(f"{key}: resume reached epoch {resumed['epoch']}, play returned {played}")
    return launches


def lstm_carry_check(agent, ts, traj) -> None:
    """After a rollout: the carry of the envs done in the last step is zero,
    every other env's is not; 24,576 windows of 4 in minibatches of 4,096."""
    if (agent.num_seqs, agent.seq_minibatch, agent.seq_length) != (24576, 4096, 4):
        raise AssertionError(f"windows {agent.num_seqs} x {agent.seq_length}, {agent.seq_minibatch} per minibatch")
    done = traj.done[-1]
    zero = all(bool((x[done] == 0).all()) for x in ts.carry)
    live = bool((ts.carry[1][~done].abs().amax(1) > 0).all())
    print(f"  carry: {int(done.sum())} envs done in the last step, their carry zero: {zero}; "
          f"the other {int((~done).sum())} non-zero: {live}")
    if not zero or not live:
        raise AssertionError("the recurrent carry was not reset where envs were done, or is zero elsewhere")


def determinism(steps: int = 16) -> None:
    """Two Ant rollouts at 4096 envs from one seed, bit for bit: env.step
    under actions from a seeded generator (the kernel and the env step), and
    `PPO.rollout` (policy forward, sampling, env) of two agents made from
    one seed. Neither needs torch.use_deterministic_algorithms here."""
    from isaacgymenvs_tpu_torch.learn import PPO

    def env_run():
        env = ant_env(NUM_ENVS)
        state, obs = env.reset(21)
        gen = torch.Generator(device="cuda").manual_seed(22)
        seen = []
        for _ in range(steps):
            state, obs, rew, _, _ = env.step(state, torch.rand(NUM_ENVS, 8, generator=gen, device="cuda") * 2 - 1)
            seen += [obs, rew[:, None]]
        return torch.cat(seen, 1), state.sim.q

    def ppo_run():
        train = {"network": {"mlp": {"units": [256, 128, 64], "activation": "elu"}},
                 "config": {"horizon_length": steps, "value_bootstrap": True}}
        agent = PPO(ant_env(NUM_ENVS), train, seed=23)
        ts, traj, last = agent.rollout(agent.init())
        return traj.obs, traj.action, traj.logp, traj.value, last, ts.env_state.sim.q

    for label, run in (("env.step", env_run), ("PPO.rollout", ppo_run)):
        a, b = run(), run()
        torch.cuda.synchronize()
        equal = all(torch.equal(x, y) for x, y in zip(a, b, strict=True))
        print(f"determinism, Ant {label} x {steps} steps at {NUM_ENVS} envs from one seed twice: bit-equal {equal}")
        if not equal:
            raise AssertionError(f"two {label} runs from one seed differ")


# ---- HumanoidAMP (nv 34: two dofs per lane, top-K cap 16, q_target), AMP, HRL ----

AMP_ENVS = 4096  # numEnvs of HumanoidAMP.yaml
AMP_SIZES = (31, 35, 34, 42, 0, 0, 1, 0, 0, 0, 0, 16, 0, 0, 8)
AMP_WIDTH = (AMP_ENVS, 16, 65536, 32768, 6)  # HumanoidAMPPPO.yaml: envs, horizon, batch, minibatch, mini-epochs
AMP_LAUNCHES = 6  # the comparison's physics calls: 3 env steps of controlFrequencyInv 2
AMP_POOL = 16384  # comparison candidates are drawn this many at a time (`amp_inputs`): the plain
# step's host side costs the same at 8192 envs, so larger pools take fewer of its calls
LYING_SHARE = 4  # one candidate in this many lies on its back, pushed in (`HumanoidAMP.lying_states`)
PAST_CAP_SHARE = 32  # one compared env in this many has more candidates in the margin than the cap


def amp_env(n: int):
    return task_env("HumanoidAMP", n)


def amp_pool(env, n: int, seed: int):
    """n comparison candidates (q, qd, q_target) on the card: one in
    LYING_SHARE on its back, pushed 3-5 cm in, the rest from the motion clip
    with the lowest point 0-1 mm in the ground; PD targets within 0.05 rad
    of the pose. Returns them and the count of lying ones (first)."""
    nl = n // LYING_SHARE
    q1, qd1 = env.lying_states(nl, seed)
    q2, qd2 = env.standing_states(n - nl, seed + 1)
    q, qd = torch.cat([q1, q2]), torch.cat([qd1, qd2])
    g = torch.Generator(device="cuda").manual_seed(seed + 2)
    return q, qd, q + 0.1 * (torch.rand(q.shape, generator=g, device="cuda") - 0.5), nl


def kernel_jitter_ok(env, p, q, qd, qt, seed: int, draws: int = 4, qfrc=None, xfrc=None, sdf=None, dyn=None):
    """Per env: the kernel's step moves by at most COND_TOL when every entry
    of q and qd is moved one ulp up or down at random (`draws` times;
    launches that count for no main path), under the joint forces `qfrc`
    (zero without), the body wrenches `xfrc` and the SDF planes `sdf` where
    given, and the packed per-env leaves `dyn`. `conditioned` moves the base's
    position alone; a solve near a tie of its restarts or its cone
    projections can sit still under that and flip under another rounding."""
    from isaacgymenvs_tpu_torch.engine import fused

    g = torch.Generator(device="cuda").manual_seed(seed)
    zero = torch.zeros_like(qd) if qfrc is None else qfrc
    run = lambda a, b: fused.physics_step_fused(env.model, p, a, b, zero, xfrc=xfrc, q_target=qt, sdf=sdf, dyn=dyn)
    ulp = lambda t: torch.nextafter(t, torch.where(torch.rand(t.shape, generator=g, device="cuda") < 0.5, -1e30, 1e30))
    k0 = run(q, qd)
    ok = torch.ones(q.shape[0], dtype=torch.bool, device="cuda")
    for _ in range(draws):
        k1 = run(ulp(q), ulp(qd))
        ok &= ((k0.q - k1.q).abs().amax(1) < COND_TOL["q"]) & ((k0.qd - k1.qd).abs().amax(1) < COND_TOL["qd"])
        for f in ("body_force", "body_torque", "dof_force"):
            d = (getattr(k0, f) - getattr(k1, f)).abs()
            ok &= d.reshape(d.shape[0], -1).amax(1) < COND_TOL["force"]
    return ok


def amp_inputs(env, n: int, seed: int):
    """n inputs (q, qd, q_target) whose AMP_LAUNCHES chained physics calls
    each pass `conditioned` (rounding moves each call by at most COND_TOL, no
    key tie at the cap, no candidate at the margin, no joint at a limit) and
    `kernel_jitter_ok`:
    the first n // PAST_CAP_SHARE lying with more candidates in the margin
    than the cap, the rest from the clip. Drawn in pools of AMP_POOL until n
    are kept; returns the inputs, the share of the drawn pools kept and the
    kept envs past the cap."""
    from isaacgymenvs_tpu_torch.engine import fused

    s, p = fused._extract(env.model), env.sim_params
    cap = fused.topk_cap(s, p)
    plain = fused._step_math_torch(s, p, torch.device("cuda"))
    want_lying = n // PAST_CAP_SHARE
    lying, standing, drawn = [], [], 0
    for k in range(64):
        q, qd, qt, nl = amp_pool(env, AMP_POOL, seed + 7919 * k)
        alive = torch.arange(AMP_POOL, device="cuda")  # the candidates that passed every call so far
        x = (q, qd)
        for launch in range(AMP_LAUNCHES):
            ok, active, _ = conditioned(env, s, (), x[0], x[1], qt[alive], None, None, p, 0)
            ok &= kernel_jitter_ok(env, p, x[0], x[1], qt[alive], seed + 31 * k + launch)
            if launch == 0:
                ok &= (active > cap) | (alive >= nl)  # the lying ones must be past the cap
            out = plain(rows(x[0][ok]), rows(x[1][ok]), torch.zeros(s.nv, int(ok.sum()), device="cuda"), None,
                        rows(qt[alive[ok]]), None)
            alive, x = alive[ok], (out[0].T.contiguous(), out[1].T.contiguous())
        lying.append(tuple(t[alive[alive < nl]] for t in (q, qd, qt)))
        standing.append(tuple(t[alive[alive >= nl]] for t in (q, qd, qt)))
        drawn += AMP_POOL
        have = lambda c: sum(len(t[0]) for t in c)
        if have(lying) >= want_lying and have(standing) >= n - want_lying:
            break
    if have(lying) < want_lying or have(standing) < n - want_lying:
        raise AssertionError(f"HumanoidAMP: {have(lying)} lying and {have(standing)} clip states of {drawn} are "
                             f"well conditioned, {want_lying} and {n - want_lying} needed")
    cat = lambda c, m: [torch.cat(t)[:m] for t in zip(*c)]
    picked = [torch.cat([a, b]).contiguous() for a, b in zip(cat(lying, want_lying), cat(standing, n - want_lying))]
    return picked, (have(lying) + have(standing)) / drawn, want_lying


def compare_amp() -> float:
    """The HumanoidAMP instantiation (nv 34, VPL 2, 42 plane contacts under
    the cap of 16, q_target) against its plain version for 3 env steps (6
    physics calls, the plain output carried) at N=RAGGED_ENVS and at full
    width, from `amp_inputs`; contact force in 75 % of the envs or more.
    Returns the largest error."""
    from isaacgymenvs_tpu_torch.engine import fused

    env4 = amp_env(AMP_ENVS)
    (q, qd, qt), kept, past = amp_inputs(env4, AMP_ENVS, seed=61)
    worst = 0.0
    for n in (RAGGED_ENVS, AMP_ENVS):
        env = env4 if n == AMP_ENVS else amp_env(n)
        sel = lambda t: t[:n].contiguous()
        zero = torch.zeros(n, env.model.nv, device="cuda")
        err = compare_model(env.model, env.sim_params, sel(q), sel(qd), zero, None, sel(qt), AMP_LAUNCHES)
        ko = fused.physics_step_fused(env.model, env.sim_params, sel(q), sel(qd), zero, q_target=sel(qt))
        pressed = float((torch.linalg.vector_norm(ko.body_force, dim=-1).amax(1) > 1.0).float().mean())
        print(f"HumanoidAMP kernel vs plain, N={n}, 3 env steps ({AMP_LAUNCHES} calls), {100 * kept:.1f} % of the "
              f"drawn states well conditioned over them, {min(past, n)} envs with more candidates in the margin than "
              f"the cap, contact force in {100 * pressed:.1f} % of envs:", json.dumps(err))
        if not pressed >= 0.75:
            raise AssertionError(f"HumanoidAMP N={n}: contact force in {pressed:.3f} of the envs")
        worst = max(worst, *err.values())
    return worst


def time_amp(card: str) -> dict:
    """`kernel_times` of the HumanoidAMP instantiation at full width, from `amp_pool`."""
    env = amp_env(AMP_ENVS)
    q, qd, qt, _ = amp_pool(env, AMP_ENVS, seed=63)
    zero = torch.zeros(env.model.nv, AMP_ENVS, device="cuda")
    print(f"HumanoidAMP: {env.control_freq_inv} launches per env step (controlFrequencyInv, no merged window), "
          f"{env.control_freq_inv * AMP_WIDTH[1]} per AMP epoch")
    return kernel_times(env, rows(q), rows(qd), zero, None, card, reps=30, qt=rows(qt))


def restored_amp_bit_equal(args, ckpt: str, ts, epochs: int) -> None:
    """`restored_bit_equal` for an AMPAgent: the policy and the
    discriminator, lr, the three normalizers (amp_rms too) and the Adam
    moments of both nets, restored into a fresh agent of another seed."""
    from isaacgymenvs_tpu_torch.learn import AMPAgent
    from isaacgymenvs_tpu_torch.tasks import task_map
    from isaacgymenvs_tpu_torch.utils.config import load_config

    cfg = load_config(args)
    fresh = AMPAgent(task_map["HumanoidAMP"](cfg["task"], device="cuda"), cfg["train"]["params"], seed=1)
    fts, epoch = fresh.restore(ckpt, fresh.init())
    trained = ts.optimizer.param_groups[0]["params"]
    same = epoch == epochs and fts.lr == ts.lr
    same &= all(torch.equal(a, b) for (_, a), b in zip(fresh.named_trainables(), trained, strict=True))
    for a, b in ((fts.obs_rms, ts.obs_rms), (fts.value_rms, ts.value_rms), (fts.amp_rms, ts.amp_rms)):
        same &= all(torch.equal(getattr(a, f), getattr(b, f)) for f in ("mean", "var", "count"))
    fst, tst = fts.optimizer.state_dict()["state"], ts.optimizer.state_dict()["state"]
    same &= set(fst) == set(tst) and all(
        torch.equal(fst[i][k].cpu(), tst[i][k].cpu()) for i in tst for k in ("step", "exp_avg", "exp_avg_sq"))
    if not same:
        raise AssertionError("HumanoidAMP: restore did not give back the trained state bit for bit")


def train_main_amp() -> int:
    """`train.main task=HumanoidAMP` at the yaml's width (4096 envs,
    HumanoidAMPPPO.yaml): 2 epochs (32 launches each, finite metrics), a
    bit-equal restore, a resume to epoch 3, and play. Returns the training
    launches."""
    from isaacgymenvs_tpu_torch import train
    from isaacgymenvs_tpu_torch.engine import _cuda

    with tempfile.TemporaryDirectory() as runs:
        args = ["task=HumanoidAMP", f"+train_dir={runs}"]
        torch.cuda.synchronize()
        _cuda.FusedStepCall.launches = 0
        t0 = time.perf_counter()
        ts, metrics = train.main([*args, "max_iterations=2"])
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
        launches = _cuda.FusedStepCall.launches
        bad = {k: v for k, v in metrics.items() if isinstance(v, float) and not np.isfinite(v)
               and k != "mean_episode_return"}
        if launches != 2 * 16 * 2 or metrics["epoch"] != 2 or bad:
            raise AssertionError(f"HumanoidAMP train.main: {launches} launches, {metrics}")
        ckpt = os.path.join(runs, "HumanoidAMP", "nn", "last_HumanoidAMP.pth")
        restored_amp_bit_equal(args, ckpt, ts, 2)
        _, resumed = train.main([*args, "max_iterations=3", f"checkpoint={ckpt}"])
        played = train.main([*args, "test=True", f"checkpoint={ckpt}"])
    print(f"train.main task=HumanoidAMP: 2 epochs x {AMP_ENVS} envs in {sec:.2f} s ({metrics['frames'] / sec:.1f} "
          f"env-steps/s with set-up), {launches} launches, disc_acc {metrics['disc_acc']:.4f} disc_reward_mean "
          f"{metrics['disc_reward_mean']:.4f}; restore bit-equal; resumed to epoch {resumed['epoch']}; played mean "
          f"return {played:.2f}")
    if resumed["epoch"] != 3 or not np.isfinite(played):
        raise AssertionError(f"HumanoidAMP: resume reached epoch {resumed['epoch']}, play returned {played}")
    return launches


def train_main_hrl() -> dict:
    """HRL on HumanoidAMP at 4096 envs (`train.params.algo.name=hrl_continuous`,
    the seeded `amp_latent` LLC): one macro step advances `progress` by
    llc_steps in every env not done in it (2 x llc_steps launches); then
    `train.main` for 2 epochs (16 macro steps of llc_steps env steps each),
    a resume to epoch 3 and play. Returns the launches of the macro step and
    of the training run, and the macro step's seconds."""
    from isaacgymenvs_tpu_torch import train
    from isaacgymenvs_tpu_torch.engine import _cuda
    from isaacgymenvs_tpu_torch.learn import HRL
    from isaacgymenvs_tpu_torch.tasks import task_map
    from isaacgymenvs_tpu_torch.utils.config import load_config

    override = "train.params.algo.name=hrl_continuous"
    cfg = load_config(["task=HumanoidAMP", override])
    agent = HRL(task_map["HumanoidAMP"](cfg["task"], device="cuda"), cfg["train"]["params"], seed=0)
    ts = agent.init()
    k = agent._llc_steps
    g = torch.Generator(device="cuda").manual_seed(71)
    latent = torch.randn(AMP_ENVS, agent._latent_dim, generator=g, device="cuda")
    agent.env_step(ts.env_state, ts.obs, latent)  # warm-up
    p0 = ts.env_state.progress.clone()
    torch.cuda.synchronize()
    _cuda.FusedStepCall.launches = 0
    t0 = time.perf_counter()
    es, obs, rew, done, _ = agent.env_step(ts.env_state, ts.obs, latent)
    torch.cuda.synchronize()
    macro_sec = time.perf_counter() - t0
    out = {"macro": _cuda.FusedStepCall.launches}
    moved = bool(((es.progress - p0 == k) | done).all())
    print(f"HRL macro step: {k} env steps x {AMP_ENVS} envs in {macro_sec:.4f} s, {out['macro']} launches, "
          f"progress advanced by {k} where not done: {moved}, done in {int(done.sum())} envs, "
          f"mean reward {float(rew.mean()):.4f}")
    if out["macro"] != 2 * k or not moved or tuple(obs.shape) != (AMP_ENVS, 105):
        raise AssertionError("HRL: the macro step did not run llc_steps env steps")
    del agent, ts, es
    with tempfile.TemporaryDirectory() as runs:
        args = ["task=HumanoidAMP", override, f"+train_dir={runs}"]
        torch.cuda.synchronize()
        _cuda.FusedStepCall.launches = 0
        t0 = time.perf_counter()
        _, metrics = train.main([*args, "max_iterations=2"])
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
        out["train"] = _cuda.FusedStepCall.launches
        bad = {k_: v for k_, v in metrics.items() if isinstance(v, float) and not np.isfinite(v)
               and k_ != "mean_episode_return"}
        if out["train"] != 2 * 16 * k * 2 or metrics["epoch"] != 2 or bad:
            raise AssertionError(f"HRL train.main: {out['train']} launches, {metrics}")
        ckpt = os.path.join(runs, "HumanoidAMP", "nn", "last_HumanoidAMP.pth")
        _, resumed = train.main([*args, "max_iterations=3", f"checkpoint={ckpt}"])
        played = train.main([*args, "test=True", f"checkpoint={ckpt}"])
    print(f"train.main task=HumanoidAMP {override}: 2 epochs x 16 macro steps x {k} env steps x {AMP_ENVS} envs in "
          f"{sec:.2f} s ({2 * 16 * k * AMP_ENVS / sec:.1f} env-steps/s with set-up), {out['train']} launches, kl "
          f"{metrics['kl']:.5f}; resumed to epoch {resumed['epoch']}; played mean return {played:.2f}")
    if resumed["epoch"] != 3 or not np.isfinite(played):
        raise AssertionError(f"HRL: resume reached epoch {resumed['epoch']}, play returned {played}")
    out["macro_sec"] = macro_sec
    return out


# ---- FrankaCubeStack (OSC) and FrankaCabinet: pair rows under the top-K cap, the controllers ----

# task -> the yaml's full width: envs, horizon, batch, minibatch, mini-epochs (FrankaCubeStackPPO.yaml,
# FrankaCabinetPPO.yaml)
FRANKA_WIDTH = {"FrankaCubeStack": (8192, 32, 262144, 16384, 5), "FrankaCabinet": (4096, 16, 65536, 8192, 8)}
# the size tuples but for the envs per block, which the card's shared memory decides
FRANKA_SIZES = {"FrankaCubeStack": (15, 23, 21, 0, 40, 0, 1, 0, 0, 0, 0, 20, 0, 0),
                "FrankaCabinet": (19, 13, 13, 0, 24, 0, 1, 0, 0, 0, 0, 16, 0, 0)}
FRANKA_LAUNCHES = 3  # the comparison's physics calls: 3 env steps of controlFrequencyInv 1
FRANKA_POOL = 16384  # comparison candidates are drawn this many at a time (`franka_inputs`)
# share of the comparison envs that must carry contact force on the cubes / the handle bar in the
# kernel's first call (a finger under the bar may sag off it under gravity within the step)
FRANKA_PRESSED = {"FrankaCubeStack": 0.9, "FrankaCabinet": 0.5}


def franka_holder(env):
    """What `conditioned` reads of an env: the model and the scalar dofs
    whose limits it checks (the Franka's, and the cabinet's)."""
    from types import SimpleNamespace

    sdofs = env.scalar_dof_indices
    m = env.model
    dev = "cuda"
    return SimpleNamespace(model=m, dof_idx=torch.tensor(sdofs, device=dev),
                           dof_q_idx=torch.tensor([m.q_adr[m.dof_body[d]] for d in sdofs], device=dev))


def franka_forces(env, q, qd):
    """The comparison's joint forces and PD setpoints (N, nv), (N, nq):
    FrankaCubeStack's OSC for a zero task-space increment (it holds the
    grip site against the posture term, without gravity compensation, as
    the reference's), FrankaCabinet none; every drive holds its joint where
    it is."""
    qfrc = torch.zeros_like(qd)
    if getattr(env, "control_type", None) == "osc":
        qfrc[:, env.v_idx[:7]] = env.osc_torques(torch.zeros(q.shape[0], 6, device="cuda"), q, qd)
    return qfrc, q.clone()


def float32_noise(env, s, p, q, qd, qfrc, qt, xfrc=None, sdf=None) -> None:
    """Prints the float32 rounding noise of the plain step on these
    unfiltered inputs (with the body wrenches `xfrc` and the SDF planes
    `sdf` where given): per env, the largest gap of its force outputs and of
    qd between the plain step in float32 and in float64 (median, 99th
    percentile, largest, and the envs past the force tolerance)."""
    from isaacgymenvs_tpu_torch.engine import fused

    ins = (rows(q), rows(qd), rows(qfrc), None if xfrc is None else xfrc_rows(xfrc), rows(qt), None, None, 0, sdf)
    a = fused._step_math_torch(s, p, torch.device("cuda"))(*ins)
    b = fused._step_math_torch(s, p, torch.device("cuda"), dtype=torch.float64)(*(
        x.double() if isinstance(x, torch.Tensor) else x for x in ins))
    force = torch.stack([(a[i] - b[i]).abs().amax(0) for i in (2, 3, 4)]).amax(0)
    vel = (a[1] - b[1]).abs().amax(0)
    qs = lambda t: [float(x) for x in torch.quantile(t.double(), torch.tensor([0.5, 0.99], device="cuda",
                                                                                dtype=torch.float64))]
    print(f"{type(env).__name__}: the plain step in float32 against float64 on {q.shape[0]} unfiltered contact "
          f"states: forces median {qs(force)[0]:.3e} N, 99th percentile {qs(force)[1]:.3e}, largest "
          f"{float(force.max()):.3e} ({int((force > TOL['body_force']).sum())} envs past {TOL['body_force']}); qd "
          f"median {qs(vel)[0]:.3e}, largest {float(vel.max()):.3e}")


def franka_inputs(env, n: int, seed: int):
    """n inputs (q, qd, qfrc, q_target) from the task's `contact_states`
    whose FRANKA_LAUNCHES chained physics calls each pass `conditioned`
    (rounding moves each call by at most COND_TOL, no key tie at the cap, no
    candidate at the margin, no joint at a limit) and `kernel_jitter_ok`,
    under `franka_forces`. Drawn in pools of FRANKA_POOL until n are kept;
    returns the inputs, the share of the drawn pools kept, and the most and
    mean candidates within the margin per kept env in the first call."""
    from isaacgymenvs_tpu_torch.engine import fused

    s, p = fused._extract(env.model), env.sim_params
    plain = fused._step_math_torch(s, p, torch.device("cuda"))
    holder = franka_holder(env)
    kept, drawn, actives = [], 0, []
    for k in range(16):
        q, qd = env.contact_states(FRANKA_POOL, seed + 7919 * k)
        qfrc, qt = franka_forces(env, q, qd)
        if k == 0:
            float32_noise(env, s, p, q, qd, qfrc, qt)
        alive = torch.arange(FRANKA_POOL, device="cuda")
        x = (q, qd)
        for launch in range(FRANKA_LAUNCHES):
            ok, active, _ = conditioned(holder, s, (), x[0], x[1], qt[alive], None, None, p, 0, qfrc=qfrc[alive])
            ok &= kernel_jitter_ok(env, p, x[0], x[1], qt[alive], seed + 31 * k + launch, qfrc=qfrc[alive])
            if launch == 0:
                first_active = active
            out = plain(rows(x[0][ok]), rows(x[1][ok]), rows(qfrc[alive[ok]]), None, rows(qt[alive[ok]]), None)
            first_active = first_active[ok]
            alive, x = alive[ok], (out[0].T.contiguous(), out[1].T.contiguous())
        kept.append(tuple(t[alive] for t in (q, qd, qfrc, qt)))
        actives.append(first_active)
        drawn += FRANKA_POOL
        if sum(len(t[0]) for t in kept) >= n:
            break
    have = sum(len(t[0]) for t in kept)
    if have < n:
        raise AssertionError(f"{type(env).__name__}: {have} of {drawn} contact states are well conditioned, {n} needed")
    act = torch.cat(actives)[:n]
    return [torch.cat(t)[:n].contiguous() for t in zip(*kept)], have / drawn, (int(act.max()), float(act.float().mean()))


def compare_franka(task: str) -> float:
    """The task's instantiation against its plain version for 3 env steps
    (3 physics calls, the plain output carried) at N=RAGGED_ENVS and at
    full width, from `franka_inputs`; contact force on the cubes (on the
    handle bar) in FRANKA_PRESSED of the envs or more. Returns the largest
    error."""
    from isaacgymenvs_tpu_torch.engine import fused

    width = FRANKA_WIDTH[task][0]
    envw = task_env(task, width)
    (q, qd, qfrc, qt), share, (most, mean) = franka_inputs(envw, width, seed=91)
    m = envw.model
    bodies = ([envw.cubeA_ref.body0, envw.cubeB_ref.body0] if task == "FrankaCubeStack"
              else [m.body_names.index("cab:drawer_handle_top")])
    worst = 0.0
    for n in (RAGGED_ENVS, width):
        sel = lambda t: t[:n].contiguous()
        err = compare_model(m, envw.sim_params, sel(q), sel(qd), sel(qfrc), None, sel(qt), FRANKA_LAUNCHES)
        ko = fused.physics_step_fused(m, envw.sim_params, sel(q), sel(qd), sel(qfrc), q_target=sel(qt))
        pressed = float((torch.linalg.vector_norm(ko.body_force[:, bodies], dim=-1).amax(1) > 0.05).float().mean())
        print(f"{task} kernel vs plain, N={n}, 3 env steps ({FRANKA_LAUNCHES} calls), {100 * share:.1f} % of the "
              f"drawn contact states well conditioned over them, candidates in the margin in the first call "
              f"{mean:.2f} per env on average, {most} at most (cap {fused.topk_cap(fused._extract(m), envw.sim_params)}"
              f" of {len(m.ppair_point)}), contact force in {100 * pressed:.1f} % of envs:", json.dumps(err))
        if not pressed >= FRANKA_PRESSED[task]:
            raise AssertionError(f"{task} N={n}: contact force in {pressed:.3f} of the envs")
        worst = max(worst, *err.values())
    return worst


def time_franka(task: str, card: str) -> dict:
    """`kernel_times` of the task's instantiation at full width, from its contact states."""
    width, horizon = FRANKA_WIDTH[task][:2]
    env = task_env(task, width)
    q, qd = env.contact_states(width, seed=93)
    qfrc, qt = franka_forces(env, q, qd)
    print(f"{task}: {env.control_freq_inv} launch per env step (controlFrequencyInv), "
          f"{env.control_freq_inv * horizon} per PPO epoch")
    return kernel_times(env, rows(q), rows(qd), rows(qfrc), None, card, reps=30, qt=rows(qt))


def osc_on_card() -> None:
    """FrankaCubeStack's OSC at the yaml's 8192 envs: from the default pose
    (the reset state) a +x task-space increment gives +x grip-site
    acceleration J M^-1 tau in every env. Then, from random poses near the
    default, each function of the controller pipeline on the card against
    the same function on the CPU from the same inputs (the card's own
    upstream outputs, copied): the grip site's Jacobian and the mass matrix
    from one forward kinematics, `spd_inverse` of the arm's block, and
    `operational_space_control`, within rtol 1e-4 (atol 1e-5 of the largest
    entry)."""
    from isaacgymenvs_tpu_torch import controllers
    from isaacgymenvs_tpu_torch.engine import dynamics

    n = FRANKA_WIDTH["FrankaCubeStack"][0]
    env = task_env("FrankaCubeStack", n)
    cpu_env = task_env("FrankaCubeStack", n, device="cpu")
    m = env.model
    state, _ = env.reset(95)
    q, qd = state.sim.q, state.sim.qd
    g = torch.Generator(device="cuda").manual_seed(96)
    dpose = torch.zeros(n, 6, device="cuda")
    dpose[:, 0] = 0.1  # +x, (linear, angular) as the actions are ordered
    tau = env.osc_torques(dpose, q, qd)
    kin = dynamics.forward_kinematics(m, q, qd)
    J = controllers.body_jacobian(kin, env._anc, env._dof_body, env.hand_body, env._eef(kin.x, kin.quat))
    Minv = dynamics.spd_inverse(dynamics.mass_matrix(m, kin, (env._anc, env._dof_mask))[:, env.arm_t][:, :, env.arm_t]
                                + 1e-6 * env._eye7)
    xdd = (J[:, :, env.arm_t] @ (Minv @ tau[..., None]))[:, 3, 0]
    if not bool((xdd > 0).all()):
        raise AssertionError(f"OSC: +x error gave -x acceleration in {int((xdd <= 0).sum())} envs")
    # random poses near the default, velocities, increments
    q = q.clone()
    q[:, env.q_idx] = env.default_dof + 0.4 * (torch.rand(n, 9, generator=g, device="cuda") - 0.5)
    qd = 0.2 * (torch.rand(qd.shape, generator=g, device="cuda") - 0.5)
    err = 0.1 * (torch.rand(n, 6, generator=g, device="cuda") - 0.5)
    vel = 0.2 * (torch.rand(n, 6, generator=g, device="cuda") - 0.5)
    q_err = 0.2 * (torch.rand(n, 7, generator=g, device="cuda") - 0.5)
    kin = dynamics.forward_kinematics(m, q, qd)
    site = env._eef(kin.x, kin.quat)
    cpu = lambda t: t.cpu()
    kin_c = type(kin)(*map(cpu, kin))
    out, ref = {}, {}
    for e, k, dev_out in ((env, kin, out), (cpu_env, kin_c, ref)):
        dev_out["J"] = controllers.body_jacobian(k, e._anc, e._dof_body, e.hand_body, site.to(k.S.device))
        dev_out["M"] = dynamics.mass_matrix(m, k, (e._anc, e._dof_mask))
    M77 = out["M"][:, env.arm_t][:, :, env.arm_t] + 1e-6 * env._eye7
    out["Minv"], ref["Minv"] = dynamics.spd_inverse(M77), dynamics.spd_inverse(cpu(M77))
    J7 = out["J"][:, :, env.arm_t]
    osc = lambda J, Minv, *a, **kw: controllers.operational_space_control(
        J, Minv, *a, kp=env.kp, kd=env.kd, null_kp=env.kp_null, null_kd=env.kd_null, **kw)
    args = (err, vel, qd[:, env.v_idx[:7]])
    out["tau"] = osc(J7, out["Minv"], *args, q_err=q_err)
    ref["tau"] = osc(cpu(J7), cpu(out["Minv"]), *map(cpu, args), q_err=cpu(q_err))
    worst = {}
    for k, v in out.items():
        r = ref[k]
        worst[k] = float(((v.cpu() - r).abs() - 1e-5 * r.abs().amax()).div(r.abs()).clamp(min=0).nan_to_num().amax())
    print(f"OSC at {n} envs: +x grip-site acceleration in every env (min {float(xdd.min()):.4f} m/s^2); card vs "
          f"CPU from the same inputs, largest relative error past an atol of 1e-5 of the largest entry:",
          json.dumps(worst))
    if not max(worst.values()) < 1e-4:
        raise AssertionError(f"OSC on the card differs from the CPU run: {worst}")


def osc_share(steps: int = 4) -> None:
    """FrankaCubeStack at 8192 envs: the OSC's share of an env step, by
    wall time (synchronized) and by device ops (torch.profiler): the
    compute_force call alone against the whole env.step."""
    n = FRANKA_WIDTH["FrankaCubeStack"][0]
    env = task_env("FrankaCubeStack", n)
    state, _ = env.reset(97)
    gen = torch.Generator(device="cuda").manual_seed(98)
    act = torch.rand(n, env.num_acts, generator=gen, device="cuda") * 2 - 1
    for _ in range(2):
        state, _, _, _, _ = env.step(state, act)
    q, qd = state.sim.q, state.sim.qd

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(steps):
            fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / steps * 1e3

    osc_ms = timed(lambda: env.compute_force(act, q, qd, state.task))
    step_ms = timed(lambda: env.step(state, act))
    osc_ops = profile_window(lambda: [env.compute_force(act, q, qd, state.task) for _ in range(steps)],
                             "FrankaCubeStack compute_force (OSC)", steps, "step")
    step_ops = profile_env_step(env, steps, "FrankaCubeStack env.step")
    print(f"device ops per FrankaCubeStack env step: {step_ops:.1f}")
    print(f"FrankaCubeStack OSC share of an env step at {n} envs: {osc_ms:.3f} of {step_ms:.3f} ms wall "
          f"({100 * osc_ms / step_ms:.1f} %), {osc_ops:.1f} of {step_ops:.1f} device ops "
          f"({100 * osc_ops / step_ops:.1f} %)")


def train_main_at_width(task: str, width: int, horizon: int, epochs: int = 2, resume: bool = True,
                        overrides=(), play: bool = True, eager: bool = False) -> int:
    """`train.main task=<task> *overrides` (a recipe, a variant's switches)
    at the yaml's width: `epochs` epochs (controlFrequencyInv launches per
    env step, none with `eager`: the eager engine's route; finite metrics),
    a bit-equal restore, with `resume` a resume for one more, and with
    `play` a play with episodes cut to 16 steps (NutBoltPick's acting
    phase: 16 steps and its scripted tail). Returns the training launches."""
    from isaacgymenvs_tpu_torch import train
    from isaacgymenvs_tpu_torch.engine import _cuda
    from isaacgymenvs_tpu_torch.utils.config import load_config

    with tempfile.TemporaryDirectory() as runs:
        args = [f"task={task}", *overrides, f"+train_dir={runs}"]
        cfi = int(load_config(args)["task"]["env"].get("controlFrequencyInv", 1))
        torch.cuda.synchronize()
        _cuda.FusedStepCall.launches = 0
        t0 = time.perf_counter()
        ts, metrics = train.main([*args, f"max_iterations={epochs}"])
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
        launches = _cuda.FusedStepCall.launches
        # the means of episodes are NaN, and their extremes +-inf, in a run where no episode ended
        bad = {k: v for k, v in metrics.items() if isinstance(v, float) and not np.isfinite(v)
               and k != "mean_episode_return" and not k.startswith(("episode_cumulative_min/",
                                                                      "episode_cumulative_max/"))}
        if launches != (0 if eager else epochs * horizon * cfi) or metrics["epoch"] != epochs or bad \
                or metrics["frames"] != epochs * horizon * width:
            raise AssertionError(f"{task} {' '.join(overrides)} train.main: {launches} launches, {metrics}")
        ckpts = glob.glob(os.path.join(runs, "*", "nn", "last_*.pth"))
        if len(ckpts) != 1:
            raise AssertionError(f"{task} {' '.join(overrides)}: checkpoints {ckpts}")
        ckpt = ckpts[0]
        restored_bit_equal(task, args, ckpt, ts, epochs)
        resumed = {"epoch": epochs + 1}
        if resume:
            _, resumed = train.main([*args, f"max_iterations={epochs + 1}", f"checkpoint={ckpt}"])
        played = train.main([*args, "test=True", f"checkpoint={ckpt}", "task.env.episodeLength=16"]) if play else 0.0
    print(f"train.main task={task}{''.join(' ' + o for o in overrides)}: {epochs} epochs x {width} envs in {sec:.2f} s ({metrics['frames'] / sec:.1f} "
          f"env-steps/s with set-up), {launches} launches, kl {metrics['kl']:.5f}; restore bit-equal; "
          f"{'resumed to epoch ' + str(resumed['epoch']) if resume else 'no resume'}; "
          f"{f'played mean return {played:.2f}' if play else 'no play'}")
    if resumed["epoch"] != epochs + 1 or not np.isfinite(played):
        raise AssertionError(f"{task} {' '.join(overrides)}: resume reached epoch {resumed['epoch']}, play returned "
                             f"{played}")
    return launches


# ---- the Factory nut-bolt family: SDF grids on moving bodies, two per model ----

NUTBOLT_ENVS = 128  # numEnvs of the three yamls
NUTBOLT_WIDE = 4096
# task -> the yaml's full width: envs, horizon, batch, minibatch, mini-epochs (FactoryTaskNutBolt*PPO.yaml)
NUTBOLT_WIDTH = {"FactoryTaskNutBoltPick": (128, 120, 15360, 512, 8),
                 "FactoryTaskNutBoltPlace": (128, 120, 15360, 512, 8),
                 "FactoryTaskNutBoltScrew": (128, 128, 16384, 512, 8)}
# the size tuples but for the envs per block: 12 rims + 48 thread points + both fingers' pad points, each
# a plane row and an SDF row (the pads against the nut's grid, the nut's points against the bolt's)
NUTBOLT_SIZES = {"FactoryTaskNutBoltPick": (15, 18, 17, 144, 0, 0, 1, 0, 0, 0, 0, 16, 0, 144),
                 "FactoryTaskNutBoltPlace": (15, 18, 17, 100, 0, 0, 1, 0, 0, 0, 0, 16, 0, 100),
                 "FactoryTaskNutBoltScrew": (15, 18, 17, 72, 0, 0, 1, 0, 0, 0, 0, 16, 0, 72)}
NUTBOLT_LAUNCHES = 3  # the comparison's physics calls: 3 env steps of controlFrequencyInv 1
NUTBOLT_POOL = 2048  # comparison candidates are drawn this many at a time (`nutbolt_inputs`)
# the gap asked of the keys either side of the cap: a nut on the thread has its 48 thread points within
# 0.25 mm of the bolt and all 60 of its points within the 5 mm margin, so its keys lie about 1e-5 apart;
# 2e-6 is some 30 ulps of a coordinate half a metre out (the other rows ask KEY_GAP, 1e-4)
NUTBOLT_KEY_GAP = 2e-6
PICK_ARM = (0.3413, -0.8011, -0.0670, -1.8299, 0.0266, 1.0185, 1.0927)  # pads 30 cm from the bolt


def nutbolt_calls(env, q, qd):
    """One env step's physics inputs at (q, qd) under zero actions: the
    task's controller torques, gravity compensation and gripper setpoints,
    and the SDF planes sampled at the entry pose. NutBoltPick steps in its
    scripted closing phase, so that fingers on the nut squeeze it (while it
    acts they are driven open onto their limit at 40 mm); fingers that hold
    no nut (wider than its flats by 1 mm) are held where they are, since
    closing on nothing they would reach their limit at 0 within the three
    steps. At a limit a one-ulp difference switches the limit's spring."""
    from isaacgymenvs_tpu_torch.tasks.factory_nut_bolt import NUT_WIDTH_MIN

    n = q.shape[0]
    task = ({"t": torch.full((n,), env.rl_len, dtype=torch.int32, device="cuda")} if hasattr(env, "rl_len")
            else ())
    qfrc, xfrc, qt = env.compute_force(torch.zeros(n, env.num_acts, device="cuda"), q, qd, task)
    fingers = q[:, env.q_idx[7:]]
    qt[:, env.q_idx[7:]] = torch.where(fingers > NUT_WIDTH_MIN / 2 + 1e-3, fingers, qt[:, env.q_idx[7:]])
    return qfrc, xfrc, qt, sdf_planes(env.model, q, qd)


def nutbolt_inputs(env, n: int, seed: int):
    """n states (q, qd) from the task's `contact_states` whose
    NUTBOLT_LAUNCHES chained physics calls (each under `nutbolt_calls` at
    the plain output of the one before) pass `conditioned` (with the keys
    at the cap NUTBOLT_KEY_GAP apart) and `kernel_jitter_ok`. Drawn in pools of NUTBOLT_POOL until n are kept;
    returns them, the share of the drawn pools kept, and the most and mean
    candidates within the margin per kept env in the first call."""
    from isaacgymenvs_tpu_torch.engine import fused

    s, p = fused._extract(env.model), env.sim_params
    plain = fused._step_math_torch(s, p, torch.device("cuda"))
    holder = franka_holder(env)
    kept, drawn, actives = [], 0, []
    for k in range(16):
        q, qd = env.contact_states(NUTBOLT_POOL, seed + 7919 * k)
        if k == 0:
            qfrc, xfrc, qt, sdf = nutbolt_calls(env, q, qd)
            float32_noise(env, s, p, q, qd, qfrc, qt, xfrc=xfrc, sdf=sdf)
        alive = torch.arange(NUTBOLT_POOL, device="cuda")
        x = (q, qd)
        for launch in range(NUTBOLT_LAUNCHES):
            qfrc, xfrc, qt, sdf = nutbolt_calls(env, *x)
            ok, active, _ = conditioned(holder, s, (), x[0], x[1], qt, None, None, p, 0, qfrc=qfrc, xfrc=xfrc, sdf=sdf,
                                        key_gap=NUTBOLT_KEY_GAP)
            ok &= kernel_jitter_ok(env, p, x[0], x[1], qt, seed + 31 * k + launch, qfrc=qfrc, xfrc=xfrc, sdf=sdf)
            if launch == 0:
                first_active = active
            out = plain(rows(x[0][ok]), rows(x[1][ok]), rows(qfrc[ok]), xfrc_rows(xfrc[ok]), rows(qt[ok]), None,
                        None, 0, sdf[:, ok].contiguous())
            first_active = first_active[ok]
            alive, x = alive[ok], (out[0].T.contiguous(), out[1].T.contiguous())
            if not len(alive):
                break
        kept.append((q[alive], qd[alive]))
        actives.append(first_active)
        drawn += NUTBOLT_POOL
        if sum(len(t[0]) for t in kept) >= n:
            break
    have = sum(len(t[0]) for t in kept)
    if have < n:
        raise AssertionError(f"{type(env).__name__}: {have} of {drawn} contact states are well conditioned, "
                             f"{n} needed")
    act = torch.cat(actives)[:n]
    picked = [torch.cat(t)[:n].contiguous() for t in zip(*kept)]
    return picked, have / drawn, (int(act.max()), float(act.float().mean()))


def compare_nutbolt(task: str) -> float:
    """Rows 1x-1z: the task's instantiation (two SDF grids, the nut's on
    the free body and the bolt's on two slides; the cap of 16; q_target and
    xfrc) against its plain version for 3 env steps (3 calls, each under
    `nutbolt_calls` at the plain output of the one before) at N=RAGGED_ENVS
    and at the yaml's 128, from `nutbolt_inputs`; the nut carries contact
    force in 90 % of the envs or more, the bolt (the grid's body, the B side
    of an SDF row) in a quarter or more. Returns the largest error."""
    from isaacgymenvs_tpu_torch.engine import fused

    env = task_env(task, NUTBOLT_ENVS)
    (q, qd), share, (most, mean) = nutbolt_inputs(env, RAGGED_ENVS, seed=101)
    m, p = env.model, env.sim_params
    s = fused._extract(m)
    plain = fused._step_math_torch(s, p, torch.device("cuda"))
    nut, bolt = env.nut_ref.body0, env.bolt_body
    worst = 0.0
    for n in (RAGGED_ENVS, NUTBOLT_ENVS):
        x = (q[:n].contiguous(), qd[:n].contiguous())
        for call in range(NUTBOLT_LAUNCHES):
            qfrc, xfrc, qt, sdf = nutbolt_calls(env, *x)
            ko = fused.physics_step_fused(m, p, x[0], x[1], qfrc, xfrc=xfrc, q_target=qt, sdf=sdf)
            po = plain(rows(x[0]), rows(x[1]), rows(qfrc), xfrc_rows(xfrc), rows(qt), None, None, 0, sdf)
            err = compare_outputs(f"{task} N={n} call {call}", ko, po, s.nbody, n)
            worst = max(worst, *err.values())
            if call == 0:
                force = torch.linalg.vector_norm(ko.body_force, dim=-1)
                on_nut, on_bolt = (float((force[:, b] > 0.05).float().mean()) for b in (nut, bolt))
                print(f"{task} kernel vs plain, N={n}, call 0: {100 * share:.1f} % of the drawn contact states well "
                      f"conditioned over {NUTBOLT_LAUNCHES} calls, candidates in the margin {mean:.2f} per env on "
                      f"average, {most} at most (cap 16 of {s.nct}), contact force on the nut in "
                      f"{100 * on_nut:.1f} % of envs, on the bolt in {100 * on_bolt:.1f} %:", json.dumps(err))
                if not (on_nut >= 0.9 and on_bolt >= 0.25):
                    raise AssertionError(f"{task} N={n}: force on the nut in {on_nut:.3f}, the bolt {on_bolt:.3f}")
            x = (po[0].T.contiguous(), po[1].T.contiguous())
        print(f"{task} kernel vs plain, N={n}, {NUTBOLT_LAUNCHES} env steps: largest error {worst:.3e}")
    return worst


def yaw_of(quat):
    return 2 * torch.atan2(quat[..., 2], quat[..., 3])


def free_nut_on_threads(steps: int = 180) -> int:
    """tests/test_factory_nut_bolt.py:27 through the kernel (row 1z, the
    Screw model, its arm parked at Pick's reset pose with its pads 30 cm
    away): a free nut set on the bolt 4 mm below its top, 30 degrees about
    z, in 128 envs, under gravity for 3 s: it catches on the threads (its
    base above 30 mm), settles (the last second moves it less than 0.5 mm)
    and, settled, keeps to the helix (descent = pitch x turn / 2 pi within
    0.4 mm). Returns the launches."""
    from isaacgymenvs_tpu_torch.engine import _cuda, fused
    from isaacgymenvs_tpu_torch.tasks.factory_nut_bolt import BOLT_TOP, THREAD_PITCH

    env = task_env("FactoryTaskNutBoltScrew", NUTBOLT_ENVS)
    m, p, nq = env.model, env.sim_params, env.nq
    q = env._qpos0.repeat(NUTBOLT_ENVS, 1)
    q[:, env.q_idx[:7]] = torch.tensor(PICK_ARM, device="cuda")
    q[:, env.q_idx[7:]] = 0.04
    q[:, nq:nq + 3] = torch.tensor([0.0, 0.0, BOLT_TOP - 0.004], device="cuda")
    q[:, nq + 3:nq + 7] = torch.tensor([0.0, 0.0, np.sin(np.pi / 12), np.cos(np.pi / 12)], device="cuda")
    qd = torch.zeros(NUTBOLT_ENVS, m.nv, device="cuda")
    zs, yaws = [], []
    torch.cuda.synchronize()
    _cuda.FusedStepCall.launches = 0
    for _ in range(steps):
        _, xfrc, qt, sdf = nutbolt_calls(env, q, qd)
        out = fused.physics_step_fused(m, p, q, qd, torch.zeros_like(qd), xfrc=xfrc, q_target=qt, sdf=sdf)
        q, qd = out.q, out.qd
        zs.append(q[:, nq + 2].clone())
        yaws.append(yaw_of(q[:, nq + 3:nq + 7]))
    launches = _cuda.FusedStepCall.launches
    zs, yaws = torch.stack(zs), torch.stack(yaws)
    dz, dyaw = zs[-1] - zs[120], yaws[-1] - yaws[120]
    helix = (dz - THREAD_PITCH * dyaw / (2 * np.pi)).abs()
    print(f"free nut on the threads (row 1z, {NUTBOLT_ENVS} envs, {steps} steps, {launches} launches): base z "
          f"{float(zs[-1].min()):.5f}-{float(zs[-1].max()):.5f} m (bar > 0.030), last second moved "
          f"{float((zs[-1] - zs[120]).abs().max()):.2e} m (bar 5e-4), helix error {float(helix.max()):.2e} m "
          f"(bar 4e-4), turned {np.degrees(float((yaws[-1] - yaws[0]).abs().max())):.2f} degrees")
    if not (bool(torch.isfinite(zs).all()) and float(zs[-1].min()) > 0.030
            and float((zs[-1] - zs[120]).abs().max()) < 5e-4 and float(helix.max()) < 4e-4):
        raise AssertionError("the free nut did not rest on the threads")
    if launches != steps:
        raise AssertionError(f"{launches} launches for {steps} physics steps")
    return launches


# the share of envs whose scripted carry must reach `successes` (see place_grip_and_carry): the JAX package's
# fused path reaches 0.77 from its own 128 draws, less two standard errors of a share of 128 draws
PLACE_CARRY_SHARE = 0.7


def place_grip_and_carry() -> int:
    """tests/test_factory_nut_bolt.py:91 through the kernel (row 1y) at the
    yaml's 128 envs: 60 zero-action env steps keep the nut in the grip
    (its height within 0.02 m, no episode ends); from a fresh reset the
    scripted carry (proportional to the nut's offset from the bolt's tip)
    reaches `successes` within 150 steps in PLACE_CARRY_SHARE of the envs
    or more. The JAX test asks it of every env (two); that holds on the
    JAX package's eager engine, which the port does not have (128 of 128
    at 128 envs), while its fused path, the one the port carries, drops
    the nut from the grip in some envs and reaches 99 of 128 (77 %) from
    its own draws (PERF.md, section 6). Returns the launches."""
    from isaacgymenvs_tpu_torch.engine import _cuda
    from isaacgymenvs_tpu_torch.tasks.factory_nut_bolt import BOLT_TOP

    env = task_env("FactoryTaskNutBoltPlace", NUTBOLT_ENVS)
    nq, bq, n = env.nq, env.bolt_q, NUTBOLT_ENVS
    state, _ = env.reset(0)
    z0 = state.sim.q[:, nq + 2].clone()
    zero = torch.zeros(n, 12, device="cuda")
    torch.cuda.synchronize()
    _cuda.FusedStepCall.launches = 0
    ended = torch.zeros(n, dtype=torch.bool, device="cuda")
    for _ in range(60):
        state, _, _, done, _ = env.step(state, zero)
        ended |= done
    drift = float((state.sim.q[:, nq + 2] - z0).abs().max())
    state, _ = env.reset(1)
    succ = torch.zeros(n, device="cuda")
    for _ in range(150):
        q = state.sim.q
        a = torch.zeros(n, 12, device="cuda")
        a[:, 0:2] = torch.clamp((q[:, bq:bq + 2] - q[:, nq:nq + 2]) * 30, -1, 1)
        a[:, 2] = torch.clamp((BOLT_TOP + 0.01 - q[:, nq + 2]) * 20, -1, 1)
        state, _, _, _, ex = env.step(state, a)
        succ = torch.maximum(succ, ex["successes"])
    launches = _cuda.FusedStepCall.launches
    share = float(succ.mean())
    print(f"Place (row 1y, {n} envs): 60 zero-action steps, grip drift {drift:.4f} m (bar 0.02), episodes ended "
          f"{int(ended.sum())}; scripted carry: success in {int(succ.sum())} of {n} envs within 150 steps (bar "
          f"{PLACE_CARRY_SHARE}); {launches} launches")
    if not (drift < 0.02 and not bool(ended.any()) and share >= PLACE_CARRY_SHARE and launches == 210):
        raise AssertionError("Place lost its grip or its scripted carry missed the bolt")
    return launches


def screw_press_and_rotate(steps: int = 90) -> int:
    """tests/test_factory_nut_bolt.py:127 through the kernel (row 1z) at the
    yaml's 128 envs: pressing down and turning (z action -1, z-rotation +1,
    read one-sided as full clockwise) for 90 steps turns the nut by more
    than 60 degrees in 60 steps without ending an episode, its descent from
    step 30 to 59 follows pitch x turn / 2 pi within 6e-4 m, and it stays
    above the head (z > 0.016). Returns the launches."""
    from isaacgymenvs_tpu_torch.engine import _cuda
    from isaacgymenvs_tpu_torch.tasks.factory_nut_bolt import THREAD_PITCH

    env = task_env("FactoryTaskNutBoltScrew", NUTBOLT_ENVS)
    nq, n = env.nq, NUTBOLT_ENVS
    state, _ = env.reset(0)
    a = torch.zeros(n, 12, device="cuda")
    a[:, 2], a[:, 5] = -1.0, 1.0
    zs, yaws, dones = [], [], []
    torch.cuda.synchronize()
    _cuda.FusedStepCall.launches = 0
    for _ in range(steps):
        state, _, _, done, ex = env.step(state, a)
        zs.append(state.sim.q[:, nq + 2].clone())
        yaws.append(yaw_of(state.sim.q[:, nq + 3:nq + 7]))
        dones.append(done)
    launches = _cuda.FusedStepCall.launches
    zs, yaws, dones = torch.stack(zs), torch.stack(yaws), torch.stack(dones)
    dyaw = yaws[59] - np.radians(30.0)
    dz = zs[59] - zs[30]
    expect = THREAD_PITCH * (yaws[59] - yaws[30]) / (2 * np.pi)
    print(f"Screw press-and-rotate (row 1z, {n} envs, {steps} steps, {launches} launches): turned "
          f"{np.degrees(float(dyaw.max())):.2f} to {np.degrees(float(dyaw.min())):.2f} degrees by step 59 (bar < -60), "
          f"descent 30-59 {float(dz.mean()):.2e} m against the helix's {float(expect.mean()):.2e} (largest gap "
          f"{float((dz - expect).abs().max()):.2e}, bar 6e-4), lowest z {float(zs.min()):.4f} m (bar 0.016), "
          f"episodes ended in the first 60 steps: {int(dones[:60].sum())}, mean descent extra "
          f"{float(ex['descent'].mean()):.2e} m")
    if not (bool(torch.isfinite(zs).all()) and not bool(dones[:60].any()) and float(dyaw.max()) < -np.radians(60)
            and float((dz - expect).abs().max()) < 6e-4 and float(zs.min()) > 0.016):
        raise AssertionError("Screw's press-and-rotate missed its bars")
    if launches != steps:
        raise AssertionError(f"{launches} launches for {steps} env steps")
    return launches


def time_nutbolt(task: str, card: str) -> dict:
    """`kernel_times` of the task's instantiation at the yaml's 128 envs and
    at 4096 (as row 1s), in contact states under `nutbolt_calls`; the 4096
    figures under `<key>_4096`."""
    width, horizon = NUTBOLT_WIDTH[task][:2]
    out = {}
    for n in (NUTBOLT_ENVS, NUTBOLT_WIDE):
        env = task_env(task, NUTBOLT_ENVS)
        q, qd = env.contact_states(n, seed=103)
        qfrc, xfrc, qt, sdf = nutbolt_calls(env, q, qd)
        t = kernel_times(env, rows(q), rows(qd), rows(qfrc), xfrc_rows(xfrc), card, reps=30, qt=rows(qt), sdf=sdf)
        out.update(t if n == NUTBOLT_ENVS else {f"{k}_{n}": v for k, v in t.items() if k != "bound_by"})
    print(f"{task}: 1 launch per env step (controlFrequencyInv 1), {horizon} per PPO epoch")
    return out


# ---- IndustReal (PegsInsert, GearsInsert): caps of 32 and 64, three grids on Gears ----

INDUSTREAL_ENVS = 128  # numEnvs of both yamls
INDUSTREAL_WIDE = 4096
# task -> the yaml's full width: envs, horizon, batch, minibatch, mini-epochs (IndustRealTask*InsertPPO.yaml)
INDUSTREAL_WIDTH = {"IndustRealTaskPegsInsert": (128, 128, 16384, 8192, 8),
                    "IndustRealTaskGearsInsert": (128, 128, 16384, 8, 8)}
# the size tuples but for the envs per block: the plug's 76 points and 2 x 6 pad points (Pegs), the gear's
# 50 bore, 24 bottom and 2 x 20 pad points (Gears), each a plane row and an SDF row; caps of 32 and 64
INDUSTREAL_SIZES = {"IndustRealTaskPegsInsert": (17, 20, 19, 88, 0, 0, 1, 0, 0, 0, 0, 32, 0, 88),
                    "IndustRealTaskGearsInsert": (17, 20, 19, 114, 0, 0, 1, 0, 0, 0, 0, 64, 0, 114)}
INDUSTREAL_POOL = 2048  # comparison candidates are drawn this many at a time (`industreal_inputs`)
# the fewest rows in the margin of a Gears comparison state: more than a warp's 32 lanes, so that the
# ranking writes slots past 32 and the solve runs two slots per lane
GEARS_MIN_ACTIVE = 33
# the bars of the JAX package's slow tests through the kernel, as shares of the 128 envs (PERF.md, section 6),
# each the port's plain step's share on the CPU from its own draws less two standard errors of a share of
# 128 draws: the straight push completes the insertion (success, engagement, the plug within the success
# height of the socket's origin, the reward above the first step's: 128 of 128 on the CPU), and the gear
# pressed then held stays inserted (success, engagement, height: 64 of 128 on the CPU; the JAX package's
# eager engine kept 2 of its test's 4)
PEGS_PUSH_SHARE = 0.9
GEARS_HOLD_SHARE = 0.4


def industreal_env(task: str, n: int, overrides=(), device: str = "cuda"):
    from isaacgymenvs_tpu_torch.tasks import task_map
    from isaacgymenvs_tpu_torch.utils.config import load_config

    return task_map[task](load_config([f"task={task}", f"num_envs={n}", *overrides])["task"], device=device)


def industreal_calls(env, q, qd):
    """One env step's physics inputs at (q, qd) under zero actions: the
    task-space impedance's torques (clipped), gravity compensation, the
    closed gripper's setpoints, and the SDF planes sampled at the entry.
    PegsInsert's fingers are held where they are: the pads' points lie 6 mm
    to either side of the finger's midline, beyond the 4 mm peg, so closing
    fingers meet nothing and reach their limit at 0 within the step, where
    a one-ulp difference switches the limit's spring."""
    qfrc, xfrc, qt = env.compute_force(torch.zeros(q.shape[0], env.num_acts, device=q.device), q, qd, None)
    if "Pegs" in type(env).__name__:
        qt[:, env.q_idx[7:]] = q[:, env.q_idx[7:]]
    return qfrc, xfrc, qt, sdf_planes(env.model, q, qd)


def industreal_inputs(env, n: int, seed: int, calls: int, min_active: int = 0, call_fn=None):
    """n states (q, qd) from the task's `contact_states` whose `calls`
    chained physics calls (each under `call_fn`, by default
    `industreal_calls`, at the plain output of the one before) pass
    `conditioned` (the keys at the cap
    NUTBOLT_KEY_GAP apart) and `kernel_jitter_ok`, with more than
    `min_active` - 1 rows in the margin in the first call. Drawn in pools of
    INDUSTREAL_POOL until n are kept; returns them, the share of the drawn
    states kept, and the most, mean and fewest rows in the margin per kept
    env in the first call."""
    from isaacgymenvs_tpu_torch.engine import fused

    s, p = fused._extract(env.model), env.sim_params
    plain = fused._step_math_torch(s, p, torch.device("cuda"))
    holder = franka_holder(env)
    call_fn = call_fn or industreal_calls
    kept, drawn, actives = [], 0, []
    for k in range(24):
        q, qd = env.contact_states(INDUSTREAL_POOL, seed + 7919 * k)
        if k == 0:
            qfrc, xfrc, qt, sdf = call_fn(env, q, qd)
            float32_noise(env, s, p, q, qd, qfrc, qt, xfrc=xfrc, sdf=sdf)
        alive = torch.arange(INDUSTREAL_POOL, device="cuda")
        x = (q, qd)
        for call in range(calls):
            qfrc, xfrc, qt, sdf = call_fn(env, *x)
            ok, active, _ = conditioned(holder, s, (), x[0], x[1], qt, None, None, p, 0, qfrc=qfrc, xfrc=xfrc, sdf=sdf,
                                        key_gap=NUTBOLT_KEY_GAP)
            ok &= kernel_jitter_ok(env, p, x[0], x[1], qt, seed + 31 * k + call, qfrc=qfrc, xfrc=xfrc, sdf=sdf)
            if call == 0:
                ok &= active >= min_active
                first_active = active
            out = plain(rows(x[0][ok]), rows(x[1][ok]), rows(qfrc[ok]), xfrc_rows(xfrc[ok]), rows(qt[ok]), None,
                        None, 0, sdf[:, ok].contiguous())
            first_active = first_active[ok]
            alive, x = alive[ok], (out[0].T.contiguous(), out[1].T.contiguous())
            if not len(alive):
                break
        kept.append((q[alive], qd[alive]))
        actives.append(first_active)
        drawn += INDUSTREAL_POOL
        if sum(len(t[0]) for t in kept) >= n:
            break
    have = sum(len(t[0]) for t in kept)
    if have < n:
        raise AssertionError(f"{type(env).__name__}: {have} of {drawn} contact states are well conditioned, "
                             f"{n} needed")
    act = torch.cat(actives)[:n]
    picked = [torch.cat(t)[:n].contiguous() for t in zip(*kept)]
    return picked, have / drawn, (int(act.max()), float(act.float().mean()), int(act.min()))


def compare_industreal(task: str) -> float:
    """The task's instantiation (Pegs: cap 32 of 176 rows, two grids; Gears:
    cap 64 of 228, three grids, two on the base's yaw body) against its
    plain version at N=RAGGED_ENVS for 3 env steps and at the yaml's 128 for
    one, each call under `industreal_calls` at the plain output of the one
    before, from `industreal_inputs` (Gears: states with GEARS_MIN_ACTIVE
    rows in the margin or more, so that slots past a warp's 32 lanes hold
    rows); the plug (the gear) carries contact force in half of the envs or
    more (those resting on the floor or the plate: a plug pushed into a wall
    is pushed out within the first slice, and the step reports the last).
    Returns the largest error."""
    from isaacgymenvs_tpu_torch.engine import fused

    env = industreal_env(task, INDUSTREAL_ENVS)
    gears = "Gears" in task
    (q, qd), share, (most, mean, fewest) = industreal_inputs(env, RAGGED_ENVS, seed=111, calls=3,
                                                             min_active=GEARS_MIN_ACTIVE if gears else 0)
    m, p = env.model, env.sim_params
    s = fused._extract(m)
    plain = fused._step_math_torch(s, p, torch.device("cuda"))
    cap = fused.topk_cap(s, p)
    worst = 0.0
    for n, calls in ((RAGGED_ENVS, 3), (INDUSTREAL_ENVS, 1)):
        x = (q[:n].contiguous(), qd[:n].contiguous())
        for call in range(calls):
            qfrc, xfrc, qt, sdf = industreal_calls(env, *x)
            ko = fused.physics_step_fused(m, p, x[0], x[1], qfrc, xfrc=xfrc, q_target=qt, sdf=sdf)
            po = plain(rows(x[0]), rows(x[1]), rows(qfrc), xfrc_rows(xfrc), rows(qt), None, None, 0, sdf)
            err = compare_outputs(f"{task} N={n} call {call}", ko, po, s.nbody, n)
            worst = max(worst, *err.values())
            if call == 0:
                force = torch.linalg.vector_norm(ko.body_force[:, env.plug_body], dim=-1)
                on_plug = float((force > 0.01).float().mean())
                print(f"{task} kernel vs plain, N={n}, call 0: {100 * share:.1f} % of the drawn contact states well "
                      f"conditioned over 3 calls{' with ' + str(GEARS_MIN_ACTIVE) + ' rows in the margin or more' if gears else ''}, "
                      f"rows in the margin {mean:.2f} per env on average, {most} at most, {fewest} at fewest (cap "
                      f"{cap} of {s.nct}), contact force on the plug in {100 * on_plug:.1f} % of envs:",
                      json.dumps(err))
                if not on_plug >= 0.5:
                    raise AssertionError(f"{task} N={n}: force on the plug in {on_plug:.3f} of the envs")
            x = (po[0].T.contiguous(), po[1].T.contiguous())
        print(f"{task} kernel vs plain, N={n}, {calls} env step(s): largest error {worst:.3e}")
    return worst


def pegs_straight_push(n: int = INDUSTREAL_ENVS, device: str = "cuda") -> dict:
    """tests/test_industreal.py:104 through the kernel at the yaml's 128
    envs: the socket and the plug without xy or yaw noise, every plug spawned
    5-10 mm into the hole; one zero-action step, then 50 steps pushing
    straight down (z action -0.6). Per env the bar is the JAX test's:
    success, engagement, the reward above the first step's, and the plug's
    origin within the success height (+ 0.1 mm) of the socket's. Returns the
    shares of envs meeting each and all of them, and the launches."""
    from isaacgymenvs_tpu_torch.engine import _cuda

    env = industreal_env("IndustRealTaskPegsInsert", n, (
        "task.randomize.socket_pos_xy_noise=[0.0,0.0]", "task.randomize.socket_rot_noise=[0.0,0.0,0.0]",
        "task.randomize.plug_pos_xy_noise=[0.0,0.0]", "task.rl.initial_max_disp=0.01",
        "task.rl.curriculum_height_bound=[0.005,0.01]"), device)
    state, _ = env.reset(0)
    _cuda.FusedStepCall.launches = 0
    state, _, rew0, _, _ = env.step(state, torch.zeros(n, 6, device=device))
    a = torch.zeros(n, 6, device=device)
    a[:, 2] = -0.6
    for _ in range(50):
        state, _, rew, _, ex = env.step(state, a)
    launches = _cuda.FusedStepCall.launches
    q = state.sim.q
    dz = (q[:, env.pq + 2] - q[:, env.sq + 2]).abs()
    bars = {"successes": ex["successes"] > 0, "engaged": ex["engaged"] > 0, "reward_up": rew > rew0,
            "height": dz < env.success_height_thresh + 1e-4}
    every = torch.stack(list(bars.values())).all(0) & torch.isfinite(q).all(1)
    shares = {k: float(v.float().mean()) for k, v in bars.items()}
    shares["all"] = float(every.float().mean())
    print(f"Pegs straight push ({n} envs, 51 steps, {launches} launches): shares {json.dumps(shares)} "
          f"(bar {PEGS_PUSH_SHARE} for all four); |dz| median {float(dz.median()):.2e} m")
    return {**shares, "launches": launches}


def gears_press_and_hold(n: int = INDUSTREAL_ENVS, device: str = "cuda") -> dict:
    """tests/test_industreal.py:143 through the kernel at the yaml's 128
    envs: the base and the gear without xy noise, the gear spawned 12-15 mm
    onto the shaft, 32 position iterations (128 APGD), the two-sided z
    rotation; the centre frames 0.02 m along x from the origins; one
    zero-action step, 12 steps pressing (z action -0.25), 15 holding. Per env
    the bar is the JAX test's: success, engagement, the gear's origin below
    the base's + the success height (+ 0.1 mm). Returns the shares and the
    launches."""
    from isaacgymenvs_tpu_torch.engine import _cuda

    env = industreal_env("IndustRealTaskGearsInsert", n, (
        "task.randomize.base_pos_xy_noise=[0.0,0.0]", "task.randomize.gear_pos_xyz_noise=[0.0,0.0,0.0]",
        "task.rl.initial_max_disp=0.015", "task.rl.curriculum_height_bound=[0.012,0.015]",
        "task.rl.unidirectional_rot=False", "task.sim.physx.num_position_iterations=32",
        "task.rl.close_error_thresh=0.15"), device)
    state, _ = env.reset(0)
    pc, _, sc, _ = env._centers(state.sim.q)
    off = float(((pc[:, 0] - state.sim.q[:, env.pq]) - 0.02).abs().max())
    off = max(off, float(((sc[:, 0] - state.sim.q[:, env.sq]) - 0.02).abs().max()))
    _cuda.FusedStepCall.launches = 0
    zero = torch.zeros(n, 6, device=device)
    state, _, _, _, _ = env.step(state, zero)
    a = zero.clone()
    a[:, 2] = -0.25
    for _ in range(12):
        state, _, _, _, _ = env.step(state, a)
    for _ in range(15):
        state, _, rew, _, ex = env.step(state, zero)
    launches = _cuda.FusedStepCall.launches
    q = state.sim.q
    dz = q[:, env.pq + 2] - q[:, env.sq + 2]
    bars = {"successes": ex["successes"] > 0, "engaged": ex["engaged"] > 0,
            "height": dz < env.success_height_thresh + 1e-4}
    every = torch.stack(list(bars.values())).all(0) & torch.isfinite(q).all(1) & torch.isfinite(rew)
    shares = {k: float(v.float().mean()) for k, v in bars.items()}
    shares["all"] = float(every.float().mean())
    print(f"Gears press and hold ({n} envs, 28 steps, {launches} launches): centre frames {off:.1e} m off 0.02 "
          f"along x; shares {json.dumps(shares)} (bar {GEARS_HOLD_SHARE} for all three)")
    if not off < 1e-6:
        raise AssertionError("the gear's centre frames are not 0.02 m along x from the origins")
    return {**shares, "launches": launches}


def sbc_steps_toward_easier(n: int = INDUSTREAL_ENVS, device: str = "cuda") -> dict:
    """tests/test_industreal.py:196 through the kernel at the yaml's 128
    envs: episodes of 6 steps from a max displacement of 0; two episodes of
    zero actions (14 steps) fail, and each finished episode steps the
    shared max displacement toward easier by 0.003 (at least 0.003 in every
    env, at most the easy bound 0.01). Returns the shares and the launches."""
    from isaacgymenvs_tpu_torch.engine import _cuda

    env = industreal_env("IndustRealTaskPegsInsert", n, (
        "task.env.episodeLength=6", "task.rl.max_episode_length=6", "task.rl.initial_max_disp=0.0"), device)
    state, _ = env.reset(0)
    if float(state.task["max_disp"].abs().max()) != 0.0:
        raise AssertionError("SBC did not start at 0")
    _cuda.FusedStepCall.launches = 0
    zero = torch.zeros(n, 6, device=device)
    success = 0.0
    for _ in range(14):
        state, _, _, _, ex = env.step(state, zero)
        success = max(success, float(ex["successes"].max()))
    launches = _cuda.FusedStepCall.launches
    disp = state.task["max_disp"]
    shares = {"at_least_0.003": float((disp >= 0.003 - 1e-6).float().mean()),
              "at_most_0.01": float((disp <= 0.01 + 1e-6).float().mean())}
    print(f"SBC ({n} envs, 14 steps, {launches} launches): max displacement {float(disp.min()):.4f}-"
          f"{float(disp.max()):.4f} (bars >= 0.003 and <= 0.01 in every env), any success seen {success}; "
          f"shares {json.dumps(shares)}")
    return {**shares, "launches": launches}


def industreal_bars() -> dict:
    """The JAX package's three slow IndustReal tests through the kernel; the
    shares against PEGS_PUSH_SHARE, GEARS_HOLD_SHARE and every env for SBC.
    Returns the launches per task."""
    push, hold, sbc = pegs_straight_push(), gears_press_and_hold(), sbc_steps_toward_easier()
    if not (push["all"] >= PEGS_PUSH_SHARE and hold["all"] >= GEARS_HOLD_SHARE
            and sbc["at_least_0.003"] == 1.0 and sbc["at_most_0.01"] == 1.0):
        raise AssertionError(f"IndustReal bars missed: push {push}, hold {hold}, SBC {sbc}")
    return {"IndustRealTaskPegsInsert": push["launches"] + sbc["launches"],
            "IndustRealTaskGearsInsert": hold["launches"]}


def industreal_env_step(task: str, profile: bool = True) -> float:
    """env.step env-steps/s under random actions at the yaml's 128 envs
    (bench.measure, 4 steps after 4); with `profile` one profiled env step
    (device ops, busy share, top ops) and the reset's IK alone
    (`resample_init` of every env, which a step runs where some env resets:
    wall ms and device ops; the same code in both tasks). Returns the
    device ops per env step without a reset (0 without `profile`). The
    steps are few: the profiler takes half a millisecond per recorded op."""
    from isaacgymenvs_tpu_torch.bench import measure

    bench = measure(INDUSTREAL_ENVS, 4, reps=1, device="cuda", task=task)
    print(f"{task} env.step under random actions: {bench['env_steps_per_s']:.1f} env-steps/s "
          f"({INDUSTREAL_ENVS} envs)")
    ops = 0.0
    if profile:
        env = industreal_env(task, INDUSTREAL_ENVS)
        ops = profile_env_step(env, steps=1, label=f"{task} env.step")
        state, _ = env.reset(0)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        env.resample_init(state.rng, state.task)
        torch.cuda.synchronize()
        ik_ms = (time.perf_counter() - t0) * 1e3
        ik_ops = profile_window(lambda: env.resample_init(state.rng, state.task), f"{task} resample_init (24 IK "
                                f"iterations)", 1, "step")
        print(f"{task}: device ops per env step {ops:.1f} without a reset; the reset's IK {ik_ops:.1f} more, "
              f"{ik_ms:.2f} ms of wall, in a step where some env resets")
    return ops


def industreal_train_main() -> int:
    """`train.main task=IndustRealTaskPegsInsert` at the yaml's width (128
    envs, horizon 128, an LSTM of 256 x 2 before the MLP, PPORecurrent) for
    2 epochs: the 256-step episodes end in the second epoch, and the SBC
    update acts on that step, with the max displacement the JAX rule gives
    for the success rate it saw (`algo.new_max_disp`); a fresh PPORecurrent
    restores the checkpoint bit for bit (the env's task state included).
    Returns the training launches."""
    from isaacgymenvs_tpu_torch import train
    from isaacgymenvs_tpu_torch.engine import _cuda
    from isaacgymenvs_tpu_torch.tasks import industreal_algo as algo
    from isaacgymenvs_tpu_torch.tasks.industreal_pegs_insert import IndustRealTaskPegsInsert

    task, (width, horizon) = "IndustRealTaskPegsInsert", INDUSTREAL_WIDTH["IndustRealTaskPegsInsert"][:2]
    seen = []
    update = IndustRealTaskPegsInsert.population_update

    def recorded(self, t, done, progress):  # kept on the device: no wait for it inside the rollout
        out = update(self, t, done, progress)
        last = (progress >= self.max_episode_length - 1).float()
        n_last = last.sum()
        rate = (t["success"] * last).sum() / torch.clamp(n_last, min=1.0)
        want = algo.new_max_disp(rate, t["max_disp"], self.curriculum_height_bound, self.curriculum_height_step,
                                 self.curriculum_success_thresh, self.curriculum_failure_thresh)
        seen.append(torch.stack([n_last, rate, t["max_disp"][0], out["max_disp"][0], want[0],
                                 out["max_disp"].max() - out["max_disp"].min()]))
        return out

    IndustRealTaskPegsInsert.population_update = recorded
    try:
        with tempfile.TemporaryDirectory() as runs:
            args = [f"task={task}", f"+train_dir={runs}"]
            torch.cuda.synchronize()
            _cuda.FusedStepCall.launches = 0
            t0 = time.perf_counter()
            ts, metrics = train.main([*args, "max_iterations=2"])
            torch.cuda.synchronize()
            sec = time.perf_counter() - t0
            launches = _cuda.FusedStepCall.launches
            steps = torch.stack(seen).cpu()
            acted = [tuple(float(v) for v in row[1:]) for row in steps if row[0] > 0]
            bad = {k: v for k, v in metrics.items() if isinstance(v, float) and not np.isfinite(v)
                   and k != "mean_episode_return"}
            if launches != 2 * horizon or metrics["epoch"] != 2 or bad or metrics["frames"] != 2 * horizon * width:
                raise AssertionError(f"{task} train.main: {launches} launches, {metrics}")
            if len(acted) != 1 or acted[0][2] != acted[0][3] or acted[0][4] != 0.0 \
                    or float(ts.env_state.task["max_disp"][0]) != acted[0][2]:
                raise AssertionError(f"{task}: the SBC update did not follow new_max_disp: {acted}")
            ckpt = os.path.join(runs, task, "nn", f"last_{task}.pth")
            fts, _ = restored_bit_equal(task, args, ckpt, ts, 2)
            if not all(torch.equal(fts.env_state.task[k], ts.env_state.task[k]) for k in ts.env_state.task):
                raise AssertionError(f"{task}: restore did not give back the curriculum's state")
    finally:
        IndustRealTaskPegsInsert.population_update = update
    rate, before, after, want, _ = acted[0]
    print(f"train.main task={task}: 2 epochs x {width} envs in {sec:.2f} s ({metrics['frames'] / sec:.1f} "
          f"env-steps/s with set-up), {launches} launches, kl {metrics['kl']:.5f}; the SBC update acted once: "
          f"success rate {rate:.4f}, max displacement {before:.4f} -> {after:.4f} (new_max_disp: {want:.4f}); "
          f"restore bit-equal")
    return launches


GEARS_UPDATE_STEPS = 256  # minibatch steps of the timed update, of the yaml's 16,384 per epoch


def gears_epoch() -> int:
    """One GearsInsert epoch through `PPORecurrent.train_epoch` at 128 x 128
    (IndustRealTaskGearsInsertPPO.yaml: minibatches of 8 in windows of 4, 8
    mini-epochs: 16,384 minibatch steps). The update runs one mini-epoch
    over the first GEARS_UPDATE_STEPS x 8 windows (GEARS_UPDATE_STEPS
    minibatch steps): the full epoch's time is given as the rollout + the
    update scaled to 16,384 steps, derived. Returns the launches."""
    from isaacgymenvs_tpu_torch.engine import _cuda
    from isaacgymenvs_tpu_torch.learn import PPORecurrent
    from isaacgymenvs_tpu_torch.utils.config import load_config

    task = "IndustRealTaskGearsInsert"
    cfg = load_config([f"task={task}", "train.params.config.mini_epochs=1"])
    env = industreal_env(task, INDUSTREAL_ENVS)
    agent = PPORecurrent(env, cfg["train"]["params"], seed=0)
    if (env.num_envs, agent.cfg.horizon_length, agent.batch_size, agent.minibatch_size) != \
            INDUSTREAL_WIDTH[task][:4]:
        raise AssertionError(f"{task}: not at the yaml's width")
    agent.num_seqs = GEARS_UPDATE_STEPS * agent.seq_minibatch  # the mini-epoch draws from these windows only
    split = {}
    rollout = agent.rollout

    def timed_rollout(ts, noise=None):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = rollout(ts, noise)
        torch.cuda.synchronize()
        split["rollout"] = time.perf_counter() - t0
        return out

    agent.rollout = timed_rollout
    ts = agent.init()
    torch.cuda.synchronize()
    _cuda.FusedStepCall.launches = 0
    t0 = time.perf_counter()
    ts, metrics = agent.train_epoch(ts)
    torch.cuda.synchronize()
    sec = time.perf_counter() - t0
    launches = _cuda.FusedStepCall.launches
    update = sec - split["rollout"]
    bad = {k: v for k, v in metrics.items() if not np.isfinite(v)}
    full = split["rollout"] + 16384 / GEARS_UPDATE_STEPS * update
    print(f"{task} PPORecurrent epoch at 128 x 128, {GEARS_UPDATE_STEPS} minibatch steps: {sec:.2f} s = rollout "
          f"{split['rollout']:.2f} s + update {update:.2f} s; the yaml's 8 mini-epochs (16,384 minibatch steps), "
          f"derived: {full:.2f} s, {16384 / full:.1f} env-steps/s; {launches} launches, kl {metrics['kl']:.5f}")
    if launches != 128 or bad:
        raise AssertionError(f"{task} epoch: {launches} launches, metrics {metrics}")
    return launches


def time_industreal(task: str, card: str) -> dict:
    """`kernel_times` of the task's instantiation at the yaml's 128 envs and
    at 4096, in its `contact_states` under `industreal_calls`; the 4096
    figures under `<key>_4096`."""
    out = {}
    for n in (INDUSTREAL_ENVS, INDUSTREAL_WIDE):
        env = industreal_env(task, INDUSTREAL_ENVS)
        q, qd = env.contact_states(n, seed=113)
        qfrc, xfrc, qt, sdf = industreal_calls(env, q, qd)
        t = kernel_times(env, rows(q), rows(qd), rows(qfrc), xfrc_rows(xfrc), card, reps=30, qt=rows(qt), sdf=sdf)
        out.update(t if n == INDUSTREAL_ENVS else {f"{k}_{n}": v for k, v in t.items() if k != "bound_by"})
    print(f"{task}: 1 launch per env step (controlFrequencyInv 1), 128 per PPO epoch")
    return out


# ---- the hand tasks without ADR: Trifinger, ShadowHand, AllegroHand (pair rows, the cap of 24, tendons) ----

HAND_ENVS = 16384  # numEnvs of the three yamls
# task -> the yaml's full width: envs, horizon, batch, minibatch, mini-epochs (TrifingerPPO.yaml,
# ShadowHandPPO.yaml, AllegroHandPPO.yaml)
HAND_WIDTH = {"Trifinger": (16384, 8, 131072, 32768, 4), "ShadowHand": (16384, 8, 131072, 32768, 5),
              "AllegroHand": (16384, 8, 131072, 32768, 5)}
# the size tuples but for the envs per block: Trifinger with its yaml's domain randomization (8 per-env
# leaves and gravity, the cube's 8 corners and the 3 tips as plane rows, the tips against the cube as pair
# rows, no cap);
# ShadowHand's 114 and AllegroHand's 144 pair rows under the cap of 24, q_target, ShadowHand's 4 tendons
HAND_SIZES = {"Trifinger": (14, 16, 15, 11, 3, 0, 0, 0, 63728, 11, 13, 0, 0, 0),
              "ShadowHand": (27, 31, 30, 0, 114, 0, 1, 4, 0, 0, 0, 24, 0, 0),
              "AllegroHand": (23, 23, 22, 0, 144, 0, 1, 0, 0, 0, 0, 24, 0, 0),
              "ShadowHandOpenAI_FF": (27, 31, 30, 0, 114, 0, 1, 4, 65267, 122, 84, 24, 0, 0)}
# ShadowHand's build with its OpenAI variant's yaml: the 13 per-env leaves of its domain randomization
# (tendons, dofs, masses, friction, the object's scale, gravity) and the random force on the object (xfrc,
# forceScale 1), controlFrequencyInv 3; compared for one env step, its 3 physics calls
HAND_FF = "ShadowHandOpenAI_FF"
HAND_POOL = 4096  # comparison candidates are drawn this many at a time (`hand_inputs`)
HAND_STEPS = 3  # env steps of the comparison (AllegroHand: 2 physics calls each, controlFrequencyInv 2)
# the bars of the JAX package's tests through the kernel at the yamls' 16,384 envs, each the port's plain
# step's share on the CPU from its own draws (PERF.md, section 6) less two standard errors: the object
# rests on the palm after 60 zero-action steps (tests/test_shadow_hand.py::test_object_rests_on_palm;
# z in 0.45-0.58, no episode ended), and Trifinger's position mode tracks the default pose
# (tests/test_trifinger.py::test_position_command_mode_tracks_targets: the mean error of the upper and
# middle joints under 0.2 rad and under half of the torque mode's at zero torques)
PALM_SHARE = {"ShadowHand": 0.88, "AllegroHand": 0.94}
TRACK_BAR = (0.2, 0.5)


def hand_env(task: str, n: int, overrides=(), device: str = "cuda"):
    """The task at n envs; a variant yaml reaches its class through its `name:`."""
    from isaacgymenvs_tpu_torch.tasks import task_map
    from isaacgymenvs_tpu_torch.utils.config import load_config

    cfg = load_config([f"task={task}", f"num_envs={n}", *overrides])["task"]
    return task_map[cfg["name"]](cfg, device=device)


def hand_calls(env, q, qd):
    """One physics call's inputs at (q, qd): Trifinger's torques at zero
    actions (the safety damping alone), a hand's PD setpoints held at its
    joints' positions and, where its yaml's forceScale is above 0
    (ShadowHandOpenAI_FF), a random force on the object as the task draws
    its kicks (normal, times the object's mass and forceScale), seeded by
    the env count; (qfrc, xfrc, q_target or None)."""
    from isaacgymenvs_tpu_torch import maths

    if not env.use_pd_targets:
        qfrc, xfrc = env.compute_force(torch.zeros(q.shape[0], env.num_acts, device=q.device), q, qd, None)
        return qfrc, xfrc, None
    from isaacgymenvs_tpu_torch.tasks.shadow_hand import ShadowHand

    idx, held = env.actuated_idx, q[:, env.hand_q_idx]
    hold = torch.clamp(maths.unscale(held[:, idx], env.dof_lower[idx], env.dof_upper[idx]), -1.0, 1.0)
    task = {"targets": held}
    if getattr(env, "force_scale", 0.0) > 0.0:
        gen = torch.Generator(device=q.device).manual_seed(q.shape[0])
        task["rb_force"] = torch.randn(q.shape[0], 3, generator=gen, device=q.device) * env.object_mass \
            * env.force_scale
    # the hand's own drives (DeXtreme's corruption of the actions left out)
    return ShadowHand.compute_force(env, hold, q, qd, task)


def hand_dyn(env, n: int, seed: int):
    """The packed per-env leaves of a draw of the task's domain
    randomization at n envs (with ADR, through `dextreme_overrides`), or
    None without it."""
    if env.randomizer is None:
        return None
    adr = None if env.adr is None else dextreme_overrides(env, n)
    return env.pack_dyn(env.randomizer.sample(torch.Generator(device="cuda").manual_seed(seed), n, 0, adr=adr))


def hand_inputs(env, n: int, seed: int, calls: int):
    """n states (q, qd) from the task's `contact_states` (with Trifinger's
    per-env leaves, a draw of its yaml's randomization) whose `calls` chained
    physics calls (each under `hand_calls` at the plain output of the one
    before) pass `conditioned` and `kernel_jitter_ok`. Drawn in pools of
    HAND_POOL until n are kept; returns them, the packed leaves of the kept
    envs (`fused.PackedDyn`) or None, the share of the drawn states kept, and the rows in the
    margin of the kept envs in the first call."""
    from isaacgymenvs_tpu_torch.engine import fused

    s, p = fused._extract(env.model), env.sim_params
    holder = franka_holder(env)
    names = ()
    kept, drawn, actives, dyns = [], 0, [], []
    for k in range(24):
        q, qd = env.contact_states(HAND_POOL, seed + 7919 * k)
        dyn = hand_dyn(env, HAND_POOL, seed + 31 * k)
        names, dyn_rows = (dyn.names, dyn.rows) if dyn is not None else ((), None)
        plain = fused._step_math_torch(s, p, torch.device("cuda"), names)
        if k == 0:
            qfrc, xfrc, qt = hand_calls(env, q, qd)
            print(f"{type(env).__name__} kernel vs plain inputs: {fused.topk_cap(s, p)} cap, {s.nct} rows")
        alive = torch.arange(HAND_POOL, device="cuda")
        x, d = (q, qd), dyn_rows
        for call in range(calls):
            qfrc, xfrc, qt = hand_calls(env, *x)
            ok, active, _ = conditioned(holder, s, names, x[0], x[1], qt, d, None, p, 0, qfrc=qfrc, xfrc=xfrc)
            ok &= kernel_jitter_ok(env, p, x[0], x[1], qt, seed + 31 * k + call, qfrc=qfrc, xfrc=xfrc,
                                   dyn=None if d is None else fused.PackedDyn(names, d))
            if call == 0:
                first_active = active
            sel = lambda t: None if t is None else t[ok]
            d = None if d is None else d[:, ok].contiguous()
            out = plain(rows(x[0][ok]), rows(x[1][ok]), rows(qfrc[ok]), xfrc_rows(xfrc[ok]),
                        None if qt is None else rows(sel(qt)), d)
            first_active = first_active[ok]
            alive, x = alive[ok], (out[0].T.contiguous(), out[1].T.contiguous())
            if not len(alive):
                break
        kept.append((q[alive], qd[alive]))
        dyns.append(None if dyn_rows is None else dyn_rows[:, alive])
        actives.append(first_active)
        drawn += HAND_POOL
        if sum(len(t[0]) for t in kept) >= n:
            break
    have = sum(len(t[0]) for t in kept)
    if have < n:
        raise AssertionError(f"{type(env).__name__}: {have} of {drawn} contact states are well conditioned, "
                             f"{n} needed")
    picked = [torch.cat(t)[:n].contiguous() for t in zip(*kept)]
    dyn = None if dyns[0] is None else fused.PackedDyn(names, torch.cat(dyns, 1)[:, :n].contiguous())
    return picked, dyn, have / drawn, torch.cat(actives)[:n]


def compare_hand(task: str, steps: int = HAND_STEPS) -> float:
    """The task's instantiation against its plain version at N=RAGGED_ENVS
    for `steps` env steps (each call under `hand_calls` at the plain
    output of the one before), from `hand_inputs`: the object carries
    contact force in half of the envs or more, and (ShadowHand and its
    variant) more rows lie in the margin than the cap of 24 in some env.
    Returns the largest error."""
    from isaacgymenvs_tpu_torch.engine import fused

    env = hand_env(task, HAND_ENVS)
    calls = steps * env.control_freq_inv
    (q, qd), dyn, share, active = hand_inputs(env, RAGGED_ENVS, seed=121, calls=calls)
    m, p = env.model, env.sim_params
    s = fused._extract(m)
    plain = fused._step_math_torch(s, p, torch.device("cuda"), () if dyn is None else dyn.names)
    cap, n, worst = fused.topk_cap(s, p), RAGGED_ENVS, 0.0
    x = (q, qd)
    for call in range(calls):
        qfrc, xfrc, qt = hand_calls(env, *x)
        ko = fused.physics_step_fused(m, p, x[0], x[1], qfrc, xfrc=xfrc, q_target=qt, dyn=dyn)
        po = plain(rows(x[0]), rows(x[1]), rows(qfrc), xfrc_rows(xfrc), None if qt is None else rows(qt),
                   None if dyn is None else dyn.rows)
        err = compare_outputs(f"{task} N={n} call {call}", ko, po, s.nbody, n)
        worst = max(worst, *err.values())
        if call == 0:
            on_obj = float((torch.linalg.vector_norm(ko.body_force[:, env.obj_ref.body0], dim=-1) > 0.01)
                           .float().mean())
            past = int((active > cap).sum()) if cap else 0
            print(f"{task} kernel vs plain, N={n}, call 0: {100 * share:.1f} % of the drawn contact states well "
                  f"conditioned over {calls} calls, rows in the margin {float(active.float().mean()):.2f} per env on "
                  f"average, {int(active.max())} at most (cap {cap} of {s.nct}; {past} envs past it), contact force "
                  f"on the object in {100 * on_obj:.1f} % of envs:", json.dumps(err))
            if not on_obj >= 0.5 or (task.startswith("ShadowHand") and not past >= 1):
                raise AssertionError(f"{task}: force on the object in {on_obj:.3f} of the envs, {past} past the cap")
        x = (po[0].T.contiguous(), po[1].T.contiguous())
    print(f"{task} kernel vs plain, N={n}, {steps} env steps ({calls} calls): largest error {worst:.3e}")
    return worst


def object_on_palm(task: str, n: int = HAND_ENVS, device: str = "cuda") -> dict:
    """tests/test_shadow_hand.py::test_object_rests_on_palm through the
    kernel at the yaml's width: 60 zero-action steps from a reset; the share
    of envs whose object lies at z 0.45-0.58 with no episode ended, and the
    launches."""
    from isaacgymenvs_tpu_torch.engine import _cuda

    env = hand_env(task, n, device=device)
    state, _ = env.reset(1)
    _cuda.FusedStepCall.launches = 0
    zero = torch.zeros(n, env.num_acts, device=device)
    ended = torch.zeros(n, dtype=torch.bool, device=device)
    for _ in range(60):
        state, _, _, done, _ = env.step(state, zero)
        ended |= done
    z = state.sim.q[:, env.obj_q + 2]
    share = float(((z > 0.45) & (z < 0.58) & ~ended).float().mean())
    print(f"{task} object on the palm after 60 zero-action steps ({n} envs, {_cuda.FusedStepCall.launches} "
          f"launches): {share:.4f} of the envs (bar {PALM_SHARE[task]}); z median {float(z.median()):.4f}")
    return {"share": share, "launches": _cuda.FusedStepCall.launches}


def trifinger_tracking(n: int = HAND_ENVS, device: str = "cuda") -> dict:
    """tests/test_trifinger.py::test_position_command_mode_tracks_targets
    through the kernel at the yaml's width (its randomization on): 40 steps
    of the position mode commanding the default pose without safety
    damping, against 40 of the torque mode at zero torques; the mean error
    of the upper and middle joints of each, and the launches."""
    from isaacgymenvs_tpu_torch.engine import _cuda

    err, launches = {}, 0
    for mode, default in (("position", True), ("torque", False)):
        env = hand_env("Trifinger", n, (f"task.env.command_mode={mode}", "task.env.apply_safety_damping=False"),
                       device)
        state, _ = env.reset(1)
        a = (2.0 * (env.default_dof - env.action_lo) / (env.action_hi - env.action_lo) - 1.0).expand(n, 9) \
            if default else torch.zeros(n, 9, device=device)
        _cuda.FusedStepCall.launches = 0
        for _ in range(40):
            state, _, _, _, _ = env.step(state, a)
        launches += _cuda.FusedStepCall.launches
        sel = torch.tensor([0, 1, 3, 4, 6, 7], device=device)
        err[mode] = float((state.sim.q[:, env.q_idx] - env.default_dof).abs()[:, sel].mean())
    print(f"Trifinger position mode tracks the default pose ({n} envs, 80 steps, {launches} launches): mean error "
          f"{err['position']:.4f} rad against {err['torque']:.4f} at zero torques (bars {TRACK_BAR[0]} and "
          f"{TRACK_BAR[1]}x)")
    return {**err, "launches": launches}


def hand_bars() -> dict:
    """The JAX package's bars through the kernel; returns the launches per task."""
    palm = {t: object_on_palm(t) for t in PALM_SHARE}
    track = trifinger_tracking()
    if not (all(palm[t]["share"] >= PALM_SHARE[t] for t in palm) and track["position"] < TRACK_BAR[0]
            and track["position"] < TRACK_BAR[1] * track["torque"]):
        raise AssertionError(f"hand bars missed: palm {palm}, tracking {track}")
    return {"Trifinger": track["launches"], **{t: palm[t]["launches"] for t in palm}}


def hand_env_step(task: str, profile: bool = True) -> float:
    """env.step env-steps/s under random actions at the yaml's width
    (bench.measure, 8 steps after 8; Trifinger with its yaml's
    randomization) and, with `profile`, one profiled env step; returns the
    device ops per env step (0 without `profile`)."""
    from isaacgymenvs_tpu_torch.bench import measure

    bench = measure(HAND_ENVS, 8, reps=1, device="cuda", task=task, randomize=task == "Trifinger")
    print(f"{task} env.step under random actions: {bench['env_steps_per_s']:.1f} env-steps/s ({HAND_ENVS} envs)")
    if not profile:
        return 0.0
    ops = profile_env_step(hand_env(task, HAND_ENVS), steps=1, label=f"{task} env.step")
    print(f"device ops per {task} env step: {ops:.1f}")
    return ops


def time_hand(task: str, card: str) -> dict:
    """`kernel_times` of the task's instantiation at the yaml's width, in its
    `contact_states` under `hand_calls` (Trifinger with a draw of its leaves)."""
    env = hand_env(task, HAND_ENVS)
    q, qd = env.contact_states(HAND_ENVS, seed=123)
    qfrc, xfrc, qt = hand_calls(env, q, qd)
    out = kernel_times(env, rows(q), rows(qd), rows(qfrc), xfrc_rows(xfrc), card, reps=30,
                       qt=None if qt is None else rows(qt), dyn=hand_dyn(env, HAND_ENVS, 125))
    print(f"{task}: {env.control_freq_inv} launch(es) per env step (controlFrequencyInv), "
          f"{env.control_freq_inv * HAND_WIDTH[task][1]} per PPO epoch")
    return out


# ---- AllegroKuka: one arm (nv 29, 32 pair rows) and two arms (nv 52, 56), no cap ----

KUKA_ENVS = 8192  # numEnvs of the AllegroKuka yamls
# task -> the yaml's full width: envs, horizon, batch, minibatch, mini-epochs (AllegroKukaReorientationPPO.yaml,
# AllegroKukaTwoArmsReorientationPPO.yaml)
KUKA_WIDTH = {"AllegroKukaReorientation": (8192, 8, 65536, 32768, 5),
              "AllegroKukaTwoArmsReorientation": (8192, 8, 65536, 32768, 5)}
# the one-arm build under AllegroKukaReorientation.yaml's domain randomization (its 10 per-env leaves and
# gravity: the arm's and the cube's dof, mass, friction and scale specs), compared for one env step
KUKA_DR = "AllegroKuka+dr"
# the size tuples but for the envs per block: the cube's corners against the table and six candidates per
# fingertip against the cube as pair rows, no plane rows, no cap, q_target (two arms: nv 52, two dofs per lane)
KUKA_SIZES = {"AllegroKukaReorientation": (28, 30, 29, 0, 32, 0, 1, 0, 0, 0, 0, 0, 0, 0),
              "AllegroKukaTwoArmsReorientation": (54, 53, 52, 0, 56, 0, 1, 0, 0, 0, 0, 0, 0, 0),
              KUKA_DR: (28, 30, 29, 0, 32, 0, 1, 0, 63731, 32, 59, 0, 0, 0)}
KUKA_STEPS = 3  # env steps of the comparison (controlFrequencyInv 1: one physics call each)
KUKA_POOL = 4096  # comparison candidates are drawn this many at a time (`kuka_inputs`)
# the bar of tests/test_allegro_kuka.py:21-32 and tests/test_allegro_kuka_two_arms.py:23-36 through the kernel
# at the yamls' 8,192 envs: after 25 zero-action steps from a reset the cube lies within KUKA_REST_TOL of its
# rest height, in this share of the envs or more: the port's plain step's share on the CPU from its own draws
# (PERF.md, section 6) less two standard errors
KUKA_REST_TOL = 5e-3
KUKA_REST_SHARE = {"AllegroKukaReorientation": 1.0, "AllegroKukaTwoArmsReorientation": 1.0}


def kuka_calls(env, q, qd):
    """One physics call's inputs at (q, qd): the task's PD targets at the
    actions that scale to the joints' positions (every drive holds its
    joint), no joint forces or body wrenches; (qfrc, xfrc, q_target)."""
    from isaacgymenvs_tpu_torch import maths

    held = torch.clamp(maths.unscale(q[:, env.q_idx], env.dof_lower, env.dof_upper), -1.0, 1.0)
    return env.compute_force(held, q, qd, None)


def tip_rows_in_margin(env, q, qd):
    """Per env, the fingertip rows within the contact margin in the first
    slice of the plain step at (q, qd) under `kuka_calls`."""
    from isaacgymenvs_tpu_torch.engine import fused

    s, p, keys = fused._extract(env.model), env.sim_params, []
    qfrc, xfrc, qt = kuka_calls(env, q, qd)
    fused._step_math_torch(s, p, torch.device("cuda"), (), keys)(rows(q), rows(qd), rows(qfrc), xfrc_rows(xfrc),
                                                                  rows(qt))
    tip = torch.tensor(np.asarray(env.model.cpoint_body)[np.asarray(env.model.ppair_point)] != env.obj_body,
                       device="cuda")
    return ((keys[0][0] > -p.contact_margin) & tip[:, None]).sum(0)


def kuka_inputs(env, n: int, seed: int, calls: int):
    """n states (q, qd) from the task's `contact_states` (with a domain
    randomization draw where the env randomizes: the cube sized by its
    scale) whose `calls` chained physics calls (each under `kuka_calls` at
    the plain output of the one before) pass `conditioned` and
    `kernel_jitter_ok`. Drawn in pools of KUKA_POOL until n are kept;
    returns them, the packed leaves of the kept envs or None, and the share
    of the drawn states kept."""
    from isaacgymenvs_tpu_torch.engine import fused

    s, p = fused._extract(env.model), env.sim_params
    holder = franka_holder(env)
    kept, dyns, drawn, names = [], [], 0, ()
    for k in range(24):
        scale, dyn_rows = None, None
        if env.randomizer is not None:
            sample = env.randomizer.sample(torch.Generator(device="cuda").manual_seed(seed + 31 * k), KUKA_POOL, 0)
            dyn = env.pack_dyn(sample)
            names, dyn_rows, scale = dyn.names, dyn.rows, sample["object.scale"]
        q, qd = env.contact_states(KUKA_POOL, seed + 7919 * k, cube_scale=scale)
        plain = fused._step_math_torch(s, p, torch.device("cuda"), names)
        alive, x, d = torch.arange(KUKA_POOL, device="cuda"), (q, qd), dyn_rows
        for call in range(calls):
            qfrc, xfrc, qt = kuka_calls(env, *x)
            ok, _, _ = conditioned(holder, s, names, x[0], x[1], qt, d, None, p, 0, qfrc=qfrc, xfrc=xfrc)
            ok &= kernel_jitter_ok(env, p, x[0], x[1], qt, seed + 31 * k + call, qfrc=qfrc, xfrc=xfrc,
                                   dyn=None if d is None else fused.PackedDyn(names, d))
            d = None if d is None else d[:, ok].contiguous()
            out = plain(rows(x[0][ok]), rows(x[1][ok]), rows(qfrc[ok]), xfrc_rows(xfrc[ok]), rows(qt[ok]), d)
            alive, x = alive[ok], (out[0].T.contiguous(), out[1].T.contiguous())
            if not len(alive):
                break
        kept.append((q[alive], qd[alive]))
        dyns.append(None if dyn_rows is None else dyn_rows[:, alive])
        drawn += KUKA_POOL
        if sum(len(t[0]) for t in kept) >= n:
            break
    have = sum(len(t[0]) for t in kept)
    if have < n:
        raise AssertionError(f"{type(env).__name__}: {have} of {drawn} contact states are well conditioned, "
                             f"{n} needed")
    picked = [torch.cat(t)[:n].contiguous() for t in zip(*kept)]
    dyn = None if dyns[0] is None else fused.PackedDyn(names, torch.cat(dyns, 1)[:, :n].contiguous())
    return picked, dyn, have / drawn


def compare_kuka(key: str) -> float:
    """Rows 1af, 1ag (and 1af'): the instantiation against its plain
    version at N=RAGGED_ENVS for KUKA_STEPS env steps and at the yaml's
    8,192 envs for one (the randomized build: N=RAGGED_ENVS for one), each
    call under `kuka_calls` at the plain output of the one before, from
    `kuka_inputs`; at the first call a fingertip row lies within the
    contact margin in half the envs or more, and the cube carries contact
    force in nine in ten. Returns the largest error."""
    from isaacgymenvs_tpu_torch.engine import fused

    task = "AllegroKukaReorientation" if key == KUKA_DR else key
    env = hand_env(task, KUKA_ENVS, ("task.task.randomize=True",) if key == KUKA_DR else ())
    runs = ((RAGGED_ENVS, 1),) if key == KUKA_DR else ((RAGGED_ENVS, KUKA_STEPS), (KUKA_ENVS, 1))
    (q, qd), dyn, share = kuka_inputs(env, max(n for n, _ in runs), seed=131, calls=runs[0][1])
    m, p = env.model, env.sim_params
    s = fused._extract(m)
    plain = fused._step_math_torch(s, p, torch.device("cuda"), () if dyn is None else dyn.names)
    worst = 0.0
    for n, steps in runs:
        x = (q[:n].contiguous(), qd[:n].contiguous())
        d = None if dyn is None else fused.PackedDyn(dyn.names, dyn.rows[:, :n].contiguous())
        for call in range(steps):
            qfrc, xfrc, qt = kuka_calls(env, *x)
            ko = fused.physics_step_fused(m, p, x[0], x[1], qfrc, xfrc=xfrc, q_target=qt, dyn=d)
            po = plain(rows(x[0]), rows(x[1]), rows(qfrc), xfrc_rows(xfrc), rows(qt), None if d is None else d.rows)
            err = compare_outputs(f"{key} N={n} call {call}", ko, po, s.nbody, n)
            worst = max(worst, *err.values())
            if call == 0:
                tips = tip_rows_in_margin(env, *x) if d is None else None
                on_tip = float((tips > 0).float().mean()) if tips is not None else float("nan")
                on_cube = float((torch.linalg.vector_norm(ko.body_force[:, env.obj_body], dim=-1) > 0.01)
                                .float().mean())
                print(f"{key} kernel vs plain, N={n}, call 0: {100 * share:.1f} % of the drawn contact states well "
                      f"conditioned over {runs[0][1]} calls, a fingertip row in the margin in {100 * on_tip:.1f} % "
                      f"of envs, contact force on the cube in {100 * on_cube:.1f} %:", json.dumps(err))
                if not on_cube >= 0.9 or (tips is not None and not on_tip >= 0.5):
                    raise AssertionError(f"{key} N={n}: a tip row in the margin in {on_tip:.3f} of the envs, "
                                         f"force on the cube in {on_cube:.3f}")
            x = (po[0].T.contiguous(), po[1].T.contiguous())
        print(f"{key} kernel vs plain, N={n}, {steps} env step(s): largest error {worst:.3e}")
    return worst


def cube_at_rest(task: str, n: int = KUKA_ENVS, device: str = "cuda") -> dict:
    """The JAX package's cube-rest bar through the kernel at the yaml's
    width: 25 zero-action steps from a reset; the share of envs whose cube
    lies within KUKA_REST_TOL of its rest height, and the launches."""
    from isaacgymenvs_tpu_torch.engine import _cuda

    env = hand_env(task, n, device=device)
    state, _ = env.reset(1)
    _cuda.FusedStepCall.launches = 0
    zero = torch.zeros(n, env.num_acts, device=device)
    for _ in range(25):
        state, obs, _, _, _ = env.step(state, zero)
    dev = (state.sim.q[:, env.oq + 2] - env.obj_init_z).abs()
    share = float((dev < KUKA_REST_TOL).float().mean())
    print(f"{task} cube at rest after 25 zero-action steps ({n} envs, {_cuda.FusedStepCall.launches} launches): "
          f"{share:.4f} of the envs within {KUKA_REST_TOL} m (bar {KUKA_REST_SHARE[task]}), largest deviation "
          f"{float(dev.max()):.2e} m; observations finite: {bool(torch.isfinite(obs).all())}")
    if not (share >= KUKA_REST_SHARE[task] and bool(torch.isfinite(obs).all())):
        raise AssertionError(f"{task}: the cube left its rest in {1 - share:.4f} of the envs")
    return {"share": share, "launches": _cuda.FusedStepCall.launches}


def kuka_env_step(task: str, profile: bool = True) -> float:
    """env.step env-steps/s under random actions at the yaml's 8,192 envs
    (bench.measure, 8 steps after 8) and, with `profile`, one profiled env
    step (device ops, busy share); returns the device ops per env step (0
    without `profile`)."""
    from isaacgymenvs_tpu_torch.bench import measure

    bench = measure(KUKA_ENVS, 8, reps=1, device="cuda", task=task)
    print(f"{task} env.step under random actions: {bench['env_steps_per_s']:.1f} env-steps/s ({KUKA_ENVS} envs)")
    if not profile:
        return 0.0
    ops = profile_env_step(hand_env(task, KUKA_ENVS), steps=1, label=f"{task} env.step")
    print(f"device ops per {task} env step: {ops:.1f}")
    return ops


def kuka_state_bank(n: int = 1024, epochs: int = 21) -> dict:
    """The saveStates path: `train.main task=AllegroKukaReorientation` with
    task.env.saveStates=True at n envs (minibatches of the batch) for
    `epochs` epochs takes one snapshot per epoch and, at exit, appends n x
    epochs // 10 rows to the bank; an env with loadInitialStates at 8,192
    envs resets every env to a bank row, and so does a partial reset within
    env.step (half the envs flagged done), whose step launches the kernel.
    Returns the launches."""
    from isaacgymenvs_tpu_torch import train
    from isaacgymenvs_tpu_torch.engine import _cuda

    task = "AllegroKukaReorientation"
    with tempfile.TemporaryDirectory() as runs:
        bank = os.path.join(runs, "bank.npz")
        _cuda.FusedStepCall.launches = 0
        train.main([f"task={task}", f"num_envs={n}", f"+train_dir={runs}", f"train.params.config.minibatch_size={8 * n}",
                    f"max_iterations={epochs}", "task.env.saveStates=True", f"task.env.saveStatesFile={bank}"])
        launches = _cuda.FusedStepCall.launches
        data = np.load(bank)
        env = hand_env(task, KUKA_ENVS, ("task.env.loadInitialStates=True", f"task.env.loadStatesFile={bank}"))
    rows_q = torch.tensor(data["q"], device="cuda")
    off_bank = lambda q: max(float(torch.cdist(c, rows_q, p=float("inf")).amin(1).max()) for c in q.split(1024))
    state, _ = env.reset(3)
    at_reset = off_bank(state.sim.q)
    state.reset_buf = torch.arange(KUKA_ENVS, device="cuda") % 2 == 0
    _cuda.FusedStepCall.launches = 0
    state, obs, _, _, _ = env.step(state, torch.zeros(KUKA_ENVS, env.num_acts, device="cuda"))
    launches += _cuda.FusedStepCall.launches
    at_step = off_bank(state.sim.q[::2])
    print(f"saveStates: train.main {epochs} epochs x {n} envs wrote {len(data['q'])} bank rows (want "
          f"{n * (epochs // 10)}); loadInitialStates at {KUKA_ENVS} envs: every reset state within {at_reset:.1e} of "
          f"a bank row, the partial reset of a step within {at_step:.1e}; {launches} launches")
    if len(data["q"]) != n * (epochs // 10) or at_reset > 1e-6 or at_step > 1e-6 or not bool(torch.isfinite(obs).all()):
        raise AssertionError("the initial-state bank was not written or not read back")
    return launches


def time_kuka(task: str, card: str) -> dict:
    """`kernel_times` of the task's instantiation at the yaml's 8,192 envs,
    in its `contact_states` under `kuka_calls`."""
    env = hand_env(task, KUKA_ENVS)
    q, qd = env.contact_states(KUKA_ENVS, seed=133)
    qfrc, xfrc, qt = kuka_calls(env, q, qd)
    out = kernel_times(env, rows(q), rows(qd), rows(qfrc), xfrc_rows(xfrc), card, reps=30, qt=rows(qt))
    print(f"{task}: 1 launch per env step (controlFrequencyInv 1), {KUKA_WIDTH[task][1]} per PPO epoch")
    return out


# ---- DeXtreme: AllegroHand under ADR (row 1ah: the ADR yaml's per-env physics leaves), the RNA, ManualDR ----

DEX_ENVS = 8192  # numEnvs of both DeXtreme yamls
# task -> the yaml's full width: envs, horizon, batch, minibatch, mini-epochs (AllegroHandDextremeADRPPO.yaml,
# AllegroHandDextremeManualDRPPO.yaml)
DEX_WIDTH = {"AllegroHandDextremeADR": (8192, 16, 131072, 16384, 4),
             "AllegroHandDextremeManualDR": (8192, 16, 131072, 16384, 4)}
# the checkpoints of train.main carry ADR's state, restored only with this gate on
ADR_GATE = "+task.env.adr.adr_load_from_checkpoint=True"
# the forced ADR run: queues of 8 and an upper threshold of 0, so that every full queue widens its edge;
# episodes of 4 steps, so that the boundary workers push every 4 steps
FORCED_ADR = ("task.env.adr.adr_queue_threshold_length=8", "task.env.adr.adr_objective_threshold_high=0",
              "task.env.resetTime=-1", "task.env.episodeLength=4")
FORCED_STEPS = 12


def dextreme_overrides(env, n: int):
    """ADR's overrides of the DR draw at n envs: the adr block's ranges
    moved 10 deltas out (within their limits), two envs in three boundary
    workers of the physics parameters in turn (each edge of each pinned in
    some envs), the third a rollout worker. ManualDR's ADR names no
    physics parameter: its DR draw takes the yaml's own ranges."""
    a = env.adr
    if not a.dr_params:
        return {}
    ids = torch.tensor([2 * p + e for p in sorted(a.dr_params.values()) for e in (0, 1)], device=a.device)
    i = torch.arange(n, device=a.device)
    wb = torch.where(i % 3 == 2, torch.full_like(i, -1), ids[i % len(ids)])
    st = a.init_state(None, workers=wb)
    st.lo = torch.maximum(st.lo - 10 * a._deltas, a._lim_lo)
    st.hi = torch.minimum(st.hi + 10 * a._deltas, a._lim_hi)
    return a.dr_overrides(st)


def dextreme_env_step(task: str, profile: bool = True) -> float:
    """env.step env-steps/s under random actions at the yaml's 8,192 envs
    (bench.measure with the yaml's randomization, 8 steps after 8) and,
    with `profile`, one profiled env step (device ops, busy share); returns
    the device ops per env step (0 without `profile`)."""
    from isaacgymenvs_tpu_torch.bench import measure

    bench = measure(DEX_ENVS, 8, reps=1, device="cuda", task=task, randomize=True)
    print(f"{task} env.step under random actions: {bench['env_steps_per_s']:.1f} env-steps/s ({DEX_ENVS} envs)")
    if not profile:
        return 0.0
    ops = profile_env_step(hand_env(task, DEX_ENVS), steps=1, label=f"{task} env.step")
    print(f"device ops per {task} env step: {ops:.1f}")
    return ops


def forced_adr_run() -> int:
    """AllegroHandDextremeADR at 8,192 envs under FORCED_ADR for
    FORCED_STEPS zero-action steps: the finished boundary workers fill their
    queues and every full queue widens its edge, so the entropy `nats` and
    the ranges move on the card. Returns the launches."""
    from isaacgymenvs_tpu_torch.engine import _cuda

    env = hand_env("AllegroHandDextremeADR", DEX_ENVS, FORCED_ADR)
    state, _ = env.reset(2)
    nats0, lo0, hi0 = float(state.adr.nats), state.adr.lo.clone(), state.adr.hi.clone()
    zero = torch.zeros(DEX_ENVS, env.num_acts, device="cuda")
    _cuda.FusedStepCall.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(FORCED_STEPS):
        state, obs, _, _, ex = env.step(state, zero)
    torch.cuda.synchronize()
    sec = time.perf_counter() - t0
    moved = int(((state.adr.lo != lo0) | (state.adr.hi != hi0)).sum())
    nats = float(state.adr.nats)
    print(f"forced ADR run ({DEX_ENVS} envs, {FORCED_STEPS} steps in {sec:.3f} s, {_cuda.FusedStepCall.launches} "
          f"launches): nats {nats0:.4f} -> {nats:.4f}, {moved} of {env.adr.P} ranges moved, extras adr_nats "
          f"{float(ex['adr_nats'][0]):.4f}; observations finite: {bool(torch.isfinite(obs).all())}")
    if not (nats > nats0 and moved >= 1 and bool(torch.isfinite(obs).all())
            and _cuda.FusedStepCall.launches == FORCED_STEPS * env.control_freq_inv):
        raise AssertionError("the forced ADR run did not move the ranges on the card")
    return _cuda.FusedStepCall.launches


def time_dextreme(task: str, card: str) -> dict:
    """`kernel_times` of the task's instantiation at the yaml's 8,192 envs,
    in its `contact_states` under `hand_calls`, with leaves drawn through
    `dextreme_overrides`."""
    env = hand_env(task, DEX_ENVS)
    q, qd = env.contact_states(DEX_ENVS, seed=137)
    qfrc, xfrc, qt = hand_calls(env, q, qd)
    out = kernel_times(env, rows(q), rows(qd), rows(qfrc), xfrc_rows(xfrc), card, reps=30, qt=rows(qt),
                       dyn=hand_dyn(env, DEX_ENVS, 139))
    print(f"{task}: {env.control_freq_inv} launches per env step (controlFrequencyInv), "
          f"{env.control_freq_inv * DEX_WIDTH[task][1]} per PPO epoch")
    return out


# ---- PBT, make() and HumanoidAMPHands ----

PBT_EPOCHS = 40  # each member's max_iterations: start-up jitter between the two stays well inside it
PBT_ALONE_EPOCHS = PBT_EPOCHS  # one member alone, for its epoch time
PBT_FRAMES = NUM_ENVS * HORIZON  # one Ant epoch: the interval, the warm-up and the delay
# two members of one Ant population at AntPPO.yaml's width; episodes of 48 steps end within the run; any
# gap to the best is a reason to adopt; every mutable param mutates at a restart (ant_mutation.yaml)
PBT_ARGS = ("task=Ant", "pbt=pbt_default", "pbt.num_policies=2", "pbt.mutation_file=ant_mutation",
            "task.env.episodeLength=48", f"pbt.interval_steps={PBT_FRAMES}", f"pbt.start_after={PBT_FRAMES}",
            f"pbt.initial_delay={PBT_FRAMES}", "pbt.replace_threshold_frac_std=0",
            "pbt.replace_threshold_frac_absolute=0", "pbt.mutation_rate=1.0")
PBT_HANDICAP = ("train.params.config.learning_rate=0", "train.params.config.lr_schedule=constant")


def _records(policy_dir: str) -> list:
    import yaml

    return [yaml.safe_load(open(os.path.join(policy_dir, f)))
            for f in sorted(os.listdir(policy_dir)) if f.endswith(".yaml")]


MINI_EPOCHS_KEY = "train.params.config.mini_epochs"


def _epoch_seconds(recs: list, mini_epochs=None) -> list:
    """Seconds between the records of consecutive iterations: one epoch of a
    member, its save and its PBT step included; with `mini_epochs`, only
    epochs run with that many mini-epochs (a mutation changes the update's
    work)."""
    return [b["timestamp"] - a["timestamp"] for a, b in zip(recs, recs[1:])
            if b["iteration"] == a["iteration"] + 1 and mini_epochs in (None, b["params"][MINI_EPOCHS_KEY])]


def _same_state(a: dict, b: dict) -> bool:
    """Two checkpoints hold the same network, normalizers, Adam moments and lr, bit for bit."""
    same = a["lr"] == b["lr"] and a["params"].keys() == b["params"].keys()
    same &= all(torch.equal(a["params"][k], b["params"][k]) for k in a["params"])
    for key in ("obs_rms", "value_rms"):
        same &= all(torch.equal(a[key][f], b[key][f]) for f in ("mean", "var", "count"))
    sa, sb = a["opt_state"]["state"], b["opt_state"]["state"]
    return same and set(sa) == set(sb) and all(torch.equal(sa[i][k], sb[i][k]) for i in sa for k in sa[i])


def _mutated_within_bounds(new: dict, sources: list) -> bool:
    """Every param of `new` is one of ant_mutation.yaml's functions applied
    to the same param of one of `sources` (the member's own params or the
    donor's), and the two differ."""
    import yaml

    from isaacgymenvs_tpu_torch.utils.config import cfg_dir

    funcs = yaml.safe_load(open(os.path.join(cfg_dir(), "pbt", "mutation", "ant_mutation.yaml")))

    def ok(k, src):
        x, y = float(src[k]), float(new[k])
        if funcs[k] == "mutate_mini_epochs":
            return y == int(y) and 1 <= y <= 8 and abs(y - x) <= 1
        if funcs[k] == "mutate_discount":
            return 1 / 1.2 - 1e-9 <= (1 - y) / (1 - x) <= 1.2 + 1e-9
        if x == 0.0:  # a factor leaves 0 at 0 (AntPPO.yaml's entropy_coef)
            return y == 0.0
        ratio = y / x
        inside = 1 / 1.5 - 1e-9 <= ratio <= 1.5 + 1e-9 and not 1 / 1.1 + 1e-9 < ratio < 1.1 - 1e-9
        return inside if funcs[k] == "mutate_float" else 0.01 <= y <= 0.3 and (inside or y in (0.01, 0.3))

    return set(new) == set(funcs) and any(new != src and all(ok(k, src) for k in funcs) for src in sources)


def pbt_population(num_envs: int = NUM_ENVS, epochs: int = PBT_EPOCHS, alone_epochs: int = PBT_ALONE_EPOCHS) -> dict:
    """The port's launcher starts two members of one Ant population at once
    on the card (`pbt.launcher.run_local`, `python -m
    isaacgymenvs_tpu_torch.train task=Ant pbt=pbt_default ...`), member 0
    handicapped (learning rate 0, constant): both exit with 0, both write
    their records into the shared workspace, and the trailing member
    restarts from the other's weights file (the copy it restored from and
    the state it restored to equal bit for bit) with mutated params inside
    their bounds. With `alone_epochs`, one member of a population of one
    runs alone first, for the epoch time of a member that has the card to
    itself. Returns the epoch seconds of each member and the restarts."""
    from isaacgymenvs_tpu_torch.pbt.launcher import TRAIN_CMD, Experiment, RunDescription, run_local
    from isaacgymenvs_tpu_torch.utils.checkpoint import load_checkpoint

    frames = num_envs * HORIZON
    args = [a.replace(str(PBT_FRAMES), str(frames)) for a in PBT_ARGS] + [f"num_envs={num_envs}"]
    out = {}
    with tempfile.TemporaryDirectory() as runs:
        base = f"{TRAIN_CMD} {' '.join(args)} +train_dir={runs}"
        if alone_epochs:
            alone = RunDescription("alone", [Experiment("member", f"{base} max_iterations={alone_epochs} "
                                                        "pbt.num_policies=1 pbt.workspace=alone",
                                                        [{"pbt.policy_idx": 0}])])
            if run_local(alone, max_parallel=1, train_dir=runs):
                raise AssertionError("PBT: the lone member failed:\n" + open(
                    os.path.join(runs, "alone", "member_00.log")).read()[-3000:])
            lone = _records(os.path.join(runs, "Ant_alone", "policy_00"))
            out["alone"], out["mini_epochs"] = _epoch_seconds(lone), lone[0]["params"][MINI_EPOCHS_KEY]
        run = RunDescription("ant_pbt", [
            Experiment("member0", f"{base} max_iterations={epochs} {' '.join(PBT_HANDICAP)}", [{"pbt.policy_idx": 0}]),
            Experiment("member1", f"{base} max_iterations={epochs}", [{"pbt.policy_idx": 1}])])
        t0 = time.perf_counter()
        failures = run_local(run, max_parallel=2, train_dir=runs)
        out["wall"] = time.perf_counter() - t0
        logs = [open(os.path.join(runs, "ant_pbt", f"member{i}_00.log")).read() for i in (0, 1)]
        if failures:
            raise AssertionError(f"PBT: {failures} member(s) failed:\n" + "\n".join(log[-3000:] for log in logs))
        ws = os.path.join(runs, "Ant_pbt_workspace")
        dirs = [os.path.join(ws, f"policy_{i:02d}") for i in (0, 1)]
        recs = [_records(d) for d in dirs]
        if not all(recs):
            raise AssertionError(f"PBT: records {[len(r) for r in recs]} in the workspace")
        restarts = []
        for i, (d, log) in enumerate(zip(dirs, logs)):
            other = os.path.abspath(os.path.join(dirs[1 - i], "weights.pth"))
            for line in log.splitlines():
                if not line.startswith(f"[pbt] policy {i}: restarted at "):
                    continue
                at, src = int(line.split()[5]), line.split(" from ")[-1]
                it = at // frames
                copied = load_checkpoint(os.path.join(d, f"restart_{it:06d}.pth"))
                restored = load_checkpoint(os.path.join(d, f"restart_{it:06d}_restored.pth"))
                before = [r for r in recs[i] if r["iteration"] <= it][-1]
                after = [r for r in recs[i] if r["iteration"] > it]
                # the donor's record the manager read is one of those at or before the iteration
                donor = [r for r in recs[1 - i] if r["iteration"] <= it]
                restarts.append({
                    "member": i, "iteration": it, "from_other": os.path.abspath(src) == other,
                    "bit_equal": _same_state(copied, restored),
                    # None where the run ended before the restarted session's first record
                    "mutated": _mutated_within_bounds(after[0]["params"], [before["params"]] + [
                        r["params"] for r in donor]) if after else None,
                    "objectives": (before["true_objective"], donor[-1]["true_objective"] if donor else None)})
        adopted = [r for r in restarts if r["from_other"]]
        checked = [r["mutated"] for r in adopted if r["mutated"] is not None]
        if not checked or not all(checked) or not all(r["bit_equal"] for r in restarts):
            raise AssertionError(f"PBT: restarts {restarts}\n" + "\n".join(log[-2000:] for log in logs))
    # side by side, the epochs that ran the lone member's (the yaml's) mini-epochs
    out.update(members=[_epoch_seconds(r, out.get("mini_epochs")) for r in recs], records=[len(r) for r in recs],
               restarts=restarts)
    med = lambda xs: statistics.median(xs) if xs else None
    out.update(member_median=[med(m) for m in out["members"]], alone_median=med(out.get("alone", [])))
    told = lambda i: [r["iteration"] for r in restarts if r["member"] == i]
    mutated = [r["mutated"] for r in restarts if r["mutated"] is not None]
    print(f"PBT, two Ant members at {num_envs} envs on one card, {epochs} epochs each: both exit 0 in "
          f"{out['wall']:.1f} s; records {out['records']}; restarts of member 0 at iterations {told(0)}, of member 1 "
          f"at {told(1)}, {sum(r['from_other'] for r in restarts)} of {len(restarts)} from the other's weights, "
          f"every one restored bit for bit; params mutated within bounds in {sum(mutated)} of the {len(mutated)} "
          f"followed by a record; epoch s (record to record"
          + (f", at {out['mini_epochs']} mini-epochs" if alone_epochs else "") + ") "
          + "; ".join(f"{who} median {med(xs)}, range {min(xs, default=None)}-{max(xs, default=None)} over {len(xs)}"
                      for who, xs in (("member 0", out["members"][0]), ("member 1", out["members"][1]),
                                      (f"one member alone ({alone_epochs} epochs)", out.get("alone", [])))))
    return out


def make_on_card() -> int:
    """`isaacgymenvs_tpu_torch.make(task="Ant")` with its default device:
    the env of the yaml's width on the card, one env step through the
    kernel. Returns its launches."""
    import isaacgymenvs_tpu_torch as port
    from isaacgymenvs_tpu_torch.engine import _cuda

    env = port.make(task="Ant", seed=0)
    state, obs = env.reset(0)
    _cuda.FusedStepCall.launches = 0
    state, obs, rew, done, _ = env.step(state, torch.zeros(env.num_envs, env.num_acts, device=env.device))
    torch.cuda.synchronize()
    launches = _cuda.FusedStepCall.launches
    print(f"make(task='Ant'): {type(env).__name__} on {env.device} with {env.num_envs} envs; one env step, "
          f"{launches} launch(es), mean reward {float(rew.mean()):.4f}")
    if env.device.type != "cuda" or env.num_envs != NUM_ENVS or launches != env.control_freq_inv \
            or not bool(torch.isfinite(obs).all()):
        raise AssertionError("make(): the env did not step on the card through the kernel")
    return launches


HANDS_GROUND_STEPS = 4


def hands_on_ground(steps: int = HANDS_GROUND_STEPS) -> int:
    """HumanoidAMPHands at 4096 envs from its yaml: the fused build is row
    1u's (the hands' spheres are candidates of the model already; only the
    termination mask differs); from reference states of the cartwheel clip,
    `steps` zero-action env steps, in which an env with a hand pressed on
    the ground (force > 0.1 N, below the termination height) is not ended
    for it, where HumanoidAMP's rule (the feet alone) would end it. Returns
    the launches."""
    from isaacgymenvs_tpu_torch.engine import _cuda, fused
    from isaacgymenvs_tpu_torch.tasks import task_map
    from isaacgymenvs_tpu_torch.utils.config import load_config

    cfg = load_config(["task=HumanoidAMPHands", f"num_envs={AMP_ENVS}"])["task"]
    env = task_map[cfg["name"]](cfg, device="cuda")
    dev = torch.device("cuda", 0)
    size = _cuda.instantiation(fused._extract(env.model), env.sim_params, dev, env.use_pd_targets, (), False)[0]
    run = amp_env(8)
    if size != _cuda.instantiation(fused._extract(run.model), run.sim_params, dev, run.use_pd_targets, (), False)[0]:
        raise AssertionError(f"HumanoidAMPHands builds {size}, not row 1u's")
    names = env.model.body_names
    hands = [names.index(n) for n in ("right_hand", "left_hand")]
    run_mask = env.noncontact_mask.clone()
    run_mask[hands] = True  # HumanoidAMP's rule: only the feet may touch
    if not torch.equal(run_mask, run.noncontact_mask) or bool(env.noncontact_mask[hands].any()):
        raise AssertionError("HumanoidAMPHands: the hands are not among the contact bodies")
    seen = {"hand_down": 0, "kept": 0, "run_would_end": 0}
    own = env.reward_done

    def reward_done(obs, q, qd, kin, sensors, task, actions, progress):
        reward, done, task = own(obs, q, qd, kin, sensors, task, actions, progress)
        x = env._poses(q)[0]
        mag = torch.linalg.vector_norm(sensors.body_force, dim=-1)
        low = x[:, :, 2] < env.termination_height
        hand = ((mag[:, hands] > 0.1) & low[:, hands]).any(1) & (progress > 1)
        run_end = ((mag > 0.1) & run_mask).any(1) & (low & run_mask).any(1) & (progress > 1)
        seen["hand_down"] += int(hand.sum())
        seen["kept"] += int((hand & ~done).sum())
        seen["run_would_end"] += int((hand & ~done & run_end).sum())
        return reward, done, task

    env.reward_done = reward_done
    state, obs = env.reset(5)
    zero = torch.zeros(AMP_ENVS, env.num_acts, device="cuda")
    _cuda.FusedStepCall.launches = 0
    for _ in range(steps):
        state, obs, _, done, _ = env.step(state, zero)
    torch.cuda.synchronize()
    launches = _cuda.FusedStepCall.launches
    print(f"HumanoidAMPHands at {AMP_ENVS} envs: row 1u's build {'_'.join(map(str, size))}; {steps} env steps from "
          f"the cartwheel clip, {launches} launches: {seen['hand_down']} env steps with a hand pressed on the ground, "
          f"{seen['kept']} of them not ended, {seen['run_would_end']} of those ended under HumanoidAMP's rule")
    if launches != steps * env.control_freq_inv or not seen["run_would_end"] or not bool(torch.isfinite(obs).all()):
        raise AssertionError(f"HumanoidAMPHands: {launches} launches, {seen}")
    return launches


def hands_train_main() -> int:
    """`train.main task=HumanoidAMPHands` with the recipe the JAX package's
    `load_config` resolves for it (none: PPO's defaults) at 4096 envs: one
    epoch, a bit-equal restore, play."""
    return train_main_at_width("HumanoidAMPHands", AMP_ENVS, 16, epochs=1, resume=False)


# ---- data parallelism: two ranks on one card (gloo), NCCL at one rank ----

DP_RANKS = 2
DP_TRAIN_EPOCHS = 3  # train.main's max_iterations under torchrun
DP_ANT = ("task=Ant",)  # the main path's epoch: AntPPO.yaml at 4,096 envs, 2,048 per rank
# AnymalTerrainPPO_LSTM at a width that keeps the step short: 1,024 envs, its horizon of 24 in windows of 4,
# minibatches of 4,096 transitions (the yaml's 6 per mini-epoch), its 5 mini-epochs
DP_LSTM = ("task=AnymalTerrain", "train=AnymalTerrainPPO_LSTM", "num_envs=1024",
           "train.params.config.minibatch_size=4096")
DP_TOL = {"rtol": 2e-4, "atol": 2e-6}  # __graft_entry__.dryrun_multichip's: a sharded epoch against one device
DP_KEYS = ("kl", "a_loss", "c_loss", "reward_mean_step")
DP_SEED = 72
# key -> (local_shuffle, the key whose action noise it takes, the key whose permutations it takes): the global
# shuffle, local_shuffle, and the control of the two: the global shuffle under local_shuffle's noise
DP_CASES = {"ant": (False, "ant", "ant"), "ant_local": (True, "ant_local", "ant_local"),
            "ant_control": (False, "ant_local", "ant")}
DP_OWN_HELD = ("ant",)  # the cases whose losses from each side's own rollout are held at DP_TOL as well
# the first minibatch step's gradient on the ranks lies within this many float32 eps (2^-23) of the gradient's
# largest element from the float64 gradient: the ranks' sums run in other orders and over rows whose normalizers
# merged the ranks' moments, a few roundings each
DP_GRAD_EPS = 4.0


def dp_agent(args, local_shuffle: bool = False):
    """The agent of `load_config(args)` (PPO, or PPORecurrent for a recipe
    with network.rnn) on the card, for this process's rank."""
    from isaacgymenvs_tpu_torch.learn import PPO, PPORecurrent
    from isaacgymenvs_tpu_torch.tasks import task_map
    from isaacgymenvs_tpu_torch.utils.config import load_config

    cfg = load_config([*args, *(["train.params.config.local_shuffle=True"] if local_shuffle else [])])
    params = cfg["train"]["params"]
    env = task_map[cfg["task"]["name"]](cfg["task"], device="cuda")
    return (PPORecurrent if params.get("network", {}).get("rnn") else PPO)(env, params, seed=int(cfg["seed"]))


def flat_grad(agent) -> torch.Tensor:
    """The trainables' gradients as the optimizer takes them, one vector."""
    return torch.cat([(torch.zeros_like(p) if p.grad is None else p.grad).reshape(-1)
                      for _, p in agent.named_trainables()])


def grad64(agent, mb, value_rms) -> torch.Tensor:
    """The control of a minibatch step's gradient: the loss of `mb` through
    a float64 twin of the policy (`flat_grad`'s order, the same clip where
    the recipe truncates)."""
    import copy

    if agent.central_net is not None:
        raise ValueError("grad64 covers the policy's trainables alone")
    net, twin = agent.network, copy.deepcopy(agent.network).double()
    agent.network = twin
    try:
        with torch.enable_grad():
            total, _ = agent._loss(tuple(x.double() for x in mb), value_rms)
            grads = torch.autograd.grad(total, list(twin.parameters()), allow_unused=True)
    finally:
        agent.network = net
    g = torch.cat([(torch.zeros_like(p) if d is None else d).reshape(-1) for p, d in zip(twin.parameters(), grads)])
    if agent.cfg.truncate_grads:
        g = g * torch.clamp(agent.cfg.grad_norm / torch.linalg.vector_norm(g), max=1.0)
    return g


def timed_epoch(agent, ts, rollout=None, capture=False, control=False, **kw) -> dict:
    """One `train_epoch`, its kernel launches counted. `rollout`, a
    (ts, traj, last_value), stands in for the epoch's own rollout. Returns
    the metrics (`steps`: each minibatch step's a_loss, c_loss, kl and lr),
    the parameters after the epoch, the seconds, the launches, the
    rollout's rewards, the first minibatch step's gradient as the optimizer
    took it (`grad`) and the parameters after that step (`params_first`);
    with `capture` the rollout as ranks take it (`rollout`: the state after
    it, `portable_state`, its Transition and last value); with `control`
    the first step's gradient in float64 (`grad64`)."""
    from isaacgymenvs_tpu_torch.engine import _cuda
    from isaacgymenvs_tpu_torch.parallel import sharding

    out, steps, step, roll = {}, [], agent._minibatch_step, agent.rollout

    def rolled(ts_, noise=None):
        res = roll(ts_, noise) if rollout is None else (ts_, *rollout[1:])
        out["reward"] = res[1].reward.cpu()
        if capture:
            out["rollout"] = {"state": sharding.portable_state(agent, res[0]), "traj": res[1], "last_value": res[2]}
        return res

    def traced(ts_, mb, value_rms, share=None):
        if control and not steps:
            out["grad64"] = grad64(agent, mb, value_rms).cpu()
        aux, xaux = step(ts_, mb, value_rms, share)
        if not steps:
            out["grad"] = flat_grad(agent).cpu()
            out["params_first"] = torch.cat([p.detach().reshape(-1) for _, p in agent.named_trainables()]).cpu()
        steps.append((float(aux[0]), float(aux[1]), float(aux[4]), ts_.lr))
        return aux, xaux

    agent._minibatch_step, agent.rollout = traced, rolled
    torch.cuda.synchronize()
    _cuda.FusedStepCall.launches = 0
    t0 = time.perf_counter()
    try:
        ts, metrics = agent.train_epoch(ts, **kw)
    finally:
        del agent._minibatch_step, agent.rollout
    torch.cuda.synchronize()
    out["sec"] = time.perf_counter() - t0
    out["launches"] = _cuda.FusedStepCall.launches
    out["metrics"] = {**metrics, "steps": steps}
    out["params"] = {n: p.detach().cpu().clone() for n, p in agent.named_trainables()}
    return out


def traj_block(traj, block: slice, n: int, owner: bool):
    """A one-process rollout of n envs cut to a rank's block: the (T, n,
    ...) leaves sliced; the per-step sums over the envs (episodes ended,
    their returns and lengths) on the rank with `owner` set and zero on the
    others, so that the ranks' sums add up to them; the per-step means of
    the env's extras kept."""
    from isaacgymenvs_tpu_torch.parallel import sharding

    cut = lambda t: t[:, block] if t.dim() > 1 and t.shape[1] == n else t
    sums = ("ep_ret_done", "ep_len_done", "n_done")
    return type(traj)(**{f: (getattr(traj, f) if owner else torch.zeros_like(getattr(traj, f))) if f in sums
                         else sharding._tree(getattr(traj, f), cut) for f in traj._fields})


def dp_inputs(workdir: str) -> dict:
    """Steps 72-73's one-process side on the card: from the reset state of
    one process (each rank takes its block), the same action noise and
    permutations, one Ant epoch per entry of DP_CASES. Writes what the
    ranks take to `workdir`: the reset state, the noise and permutations,
    and the rollout of the one-process epoch; returns the one-process
    results, with each first minibatch step's float64 gradient."""
    from isaacgymenvs_tpu_torch.parallel import sharding

    g = torch.Generator(device="cuda").manual_seed(DP_SEED)
    inputs, ref, noises, perms_of = {}, {}, {}, {}
    for key, (local, noise_key, perms_key) in DP_CASES.items():
        agent = dp_agent(DP_ANT, local)
        ts = agent.init()
        c, n, S = agent.cfg, agent.env.num_envs, 2 if local else 1
        if key == noise_key:
            noises[key] = torch.randn(c.horizon_length, n, agent.env.num_acts, generator=g, device="cuda")
        if key == perms_key:
            perms_of[key] = torch.stack([torch.randperm(agent.batch_size // S, generator=g, device="cuda")
                                         for _ in range(c.mini_epochs)])
        noise, perms = noises[noise_key], perms_of[perms_key]
        state = sharding.portable_state(agent, ts)
        agent._shuffle_shards = S
        one = timed_epoch(agent, ts, capture=True, control=True, noise=noise, perms=perms)
        inputs[key] = {"local": local, "state": state, "noise": noise, "perms": perms, "rollout": one.pop("rollout")}
        ref[key] = {**one, "batch": agent.batch_size}
    torch.save(inputs, os.path.join(workdir, "inputs.pt"))
    return ref


def dp_rank(workdir: str) -> int:
    """One rank of steps 72-74 (`python chip_smoke.py --dp-rank <workdir>`,
    under torchrun's variables): joins the gloo group on the card; for each
    entry of `dp_inputs` runs on its block one epoch with its own rollout
    and one on the one-process epoch's rollout (`traj_block`); runs one
    PPORecurrent epoch of the LSTM recipe with local_shuffle from its own
    reset (its env's draws, command resampling and pushes among them, are
    the rank's own), the forced ADR run on its block of
    AllegroHandDextremeADR (each update's gathered inputs and results
    recorded), restores the checkpoint train.main wrote under torchrun and
    holds it against the file, and saves what it saw to
    <workdir>/rank<r>.pt."""
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    watch_routes()
    from isaacgymenvs_tpu_torch.engine import _cuda
    from isaacgymenvs_tpu_torch.parallel import distributed, sharding
    from isaacgymenvs_tpu_torch.utils.checkpoint import load_checkpoint

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    distributed.maybe_initialize(require=True, backend="gloo", device="cuda")
    try:
        rank, dev = distributed.rank(), distributed.rank_device("cuda")
        inputs = torch.load(os.path.join(workdir, "inputs.pt"), map_location=dev, weights_only=False)
        out = {"rank": rank, "backend": distributed.backend()}
        warm = dp_agent(DP_ANT)  # one untimed epoch: the process's first CUDA and gloo calls
        warm.train_epoch(warm.init())
        del warm
        for key, inp in inputs.items():
            agent = dp_agent(DP_ANT, inp["local"])
            block, n = agent.env.env_block, agent.env.global_num_envs
            own = timed_epoch(agent, sharding.adopt_state(agent, inp["state"], n), noise=inp["noise"][:, block],
                              perms=inp["perms"])
            roll = inp["rollout"]
            ts = sharding.adopt_state(agent, roll["state"], n)
            same = timed_epoch(agent, ts, rollout=(ts, traj_block(roll["traj"], block, n, rank == 0),
                                                   roll["last_value"][block]), perms=inp["perms"])
            out[key] = {"own": own, "same": same, "num_envs": agent.env.num_envs, "batch": agent.batch_size}
        agent = dp_agent(DP_LSTM, True)
        out["lstm"] = {**timed_epoch(agent, agent.init()), "num_envs": agent.env.num_envs, "batch": agent.batch_size}
        # ADR over the ranks: the forced run of step 66 on this rank's block, each update recorded
        env = hand_env("AllegroHandDextremeADR", DEX_ENVS, FORCED_ADR)
        adr, records = env.adr, []
        update = adr.update

        def recorded(state, gen, done, objective, fresh_workers=None):
            twin = torch.Generator(device=gen.device)
            twin.set_state(gen.get_state())  # the draw the update is about to make from the shared stream
            gather = lambda t: sharding.all_gather_rows(t.to(torch.float64))
            pre = {**{k: v.clone() for k, v in state.as_dict().items() if k != "worker_boundary"},
                   "worker_boundary": gather(state.worker_boundary).long(), "done": gather(done) > 0,
                   "objective": gather(objective).to(objective.dtype), "fresh": adr._assign_workers(twin)}
            new = update(state, gen, done, objective, fresh_workers)
            records.append({"pre": pre, "post": new.as_dict()})
            return new

        adr.update = recorded
        state, _ = env.reset(2)
        zero = torch.zeros(env.num_envs, env.num_acts, device=dev)
        _cuda.FusedStepCall.launches = 0
        for _ in range(FORCED_STEPS):
            state, obs, _, _, _ = env.step(state, zero)
        torch.cuda.synchronize()
        out["adr"] = {"records": records, "launches": _cuda.FusedStepCall.launches, "num_envs": env.num_envs,
                      "finite": bool(torch.isfinite(obs).all())}
        # the checkpoint of train.main under torchrun (running beside), restored as a resume does
        ck_path = os.path.join(workdir, "runs", "Ant", "nn", "last_Ant.pth")
        deadline = time.perf_counter() + 600
        while not os.path.exists(ck_path) and time.perf_counter() < deadline:
            time.sleep(1.0)
        agent = dp_agent(DP_ANT)
        rts, epoch = agent.restore(ck_path, agent.init())
        ck = load_checkpoint(ck_path, dev)
        out["restored"] = epoch == DP_TRAIN_EPOCHS and rts.lr == ck["lr"] and all(
            torch.equal(p, ck["params"][n]) for n, p in agent.network.named_parameters()) and all(
            torch.equal(getattr(rts.obs_rms, f), ck["obs_rms"][f]) for f in ("mean", "var", "count"))
        out["instantiations"] = sorted(_cuda._libs)
        torch.save(out, os.path.join(workdir, f"rank{rank}.pt"))
    finally:
        distributed.shutdown()
    return 0


def start_train_main_torchrun(workdir: str):
    """Step 72's torchrun run, started ahead (`start_data_parallel`):
    `python -m torch.distributed.run --nproc_per_node=2 -m
    isaacgymenvs_tpu_torch.train task=Ant multi_gpu=True dist_backend=gloo
    max_iterations=DP_TRAIN_EPOCHS`, the ranks' output to files. Returns
    (the process, its start time); `train_main_torchrun` waits for it, and
    at exit it is killed if it still runs."""
    import atexit

    runs, logdir = os.path.join(workdir, "runs"), os.path.join(workdir, "torchrun_logs")
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", f"--nproc_per_node={DP_RANKS}",
           "--log-dir", logdir, "--redirects", "3", "-m", "isaacgymenvs_tpu_torch.train", "task=Ant",
           "multi_gpu=True", "dist_backend=gloo", f"max_iterations={DP_TRAIN_EPOCHS}", f"+train_dir={runs}"]
    proc = subprocess.Popen(cmd, cwd=os.path.dirname(os.path.abspath(__file__)), stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    atexit.register(lambda: proc.poll() is None and (proc.kill(), proc.wait()))
    return proc, time.perf_counter()


def train_main_torchrun(workdir: str, card: str, started) -> dict:
    """Step 72.2, the torchrun run of `start_train_main_torchrun`: both
    ranks exit 0; rank 0 alone prints and writes the TensorBoard log (one
    event file); the checkpoint of the last epoch is there for the ranks'
    restore."""
    runs, logdir = os.path.join(workdir, "runs"), os.path.join(workdir, "torchrun_logs")
    proc, t0 = started
    try:
        stdout, stderr = proc.communicate(timeout=400)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    res = subprocess.CompletedProcess(proc.args, proc.returncode, stdout, stderr)
    sec = time.perf_counter() - t0
    outs = {}
    for path in glob.glob(os.path.join(logdir, "**", "stdout.log"), recursive=True):
        outs[int(os.path.basename(os.path.dirname(path)))] = open(path).read()
    if res.returncode != 0:
        raise AssertionError(f"torchrun train.main exited {res.returncode}:\n{res.stdout[-2000:]}\n{res.stderr[-3000:]}"
                             + "".join(f"\nrank {r}:\n{t[-2000:]}" for r, t in sorted(outs.items())))
    events = glob.glob(os.path.join(runs, "Ant", "summaries", "events*"))
    nn = sorted(os.listdir(os.path.join(runs, "Ant", "nn")))
    ok = (sorted(outs) == list(range(DP_RANKS)) and "ranks=2 backend=gloo" in outs[0] and "epoch" in outs[0]
          and outs[1].strip() == "" and len(events) == 1 and "last_Ant.pth" in nn
          and os.path.exists(os.path.join(runs, "Ant", "config.yaml")))
    print(f"torchrun --nproc_per_node={DP_RANKS} train.main task=Ant multi_gpu=True dist_backend=gloo "
          f"max_iterations={DP_TRAIN_EPOCHS}: both ranks exit 0, {sec:.1f} s after its start ({card}); rank 0's output "
          f"{len(outs[0].splitlines())} lines, rank 1's {len(outs[1].splitlines())}; {len(events)} event file(s); "
          f"nn/ {nn}")
    if not ok:
        raise AssertionError("torchrun train.main: host effects are not rank 0's alone\n"
                             + "".join(f"\nrank {r}:\n{t[-2000:]}" for r, t in sorted(outs.items())))
    return {"sec": sec}


def start_data_parallel(workdir: str) -> dict:
    """Steps 72-74 but the NCCL one, started ahead in `workdir`: the
    one-process epochs of `dp_inputs`, then in the background the torchrun
    run and the rank pair (`--dp-rank`, their output to
    <workdir>/rank<r>.log), while steps 44-45, host-bound comparisons and
    bars whose results hang on no clock, run beside them;
    `finish_data_parallel` waits for both before step 46's timings. At
    exit a rank that still runs is killed."""
    import atexit

    from isaacgymenvs_tpu_torch.parallel import distributed

    ref = dp_inputs(workdir)
    torchrun = start_train_main_torchrun(workdir)
    ranks = distributed.start_ranks([sys.executable, os.path.abspath(__file__), "--dp-rank", workdir],
                                    [os.path.join(workdir, f"rank{r}.log") for r in range(DP_RANKS)])
    atexit.register(lambda: [(p.kill(), p.wait()) for p in ranks if p.poll() is None])
    return {"ref": ref, "torchrun": torchrun, "ranks": ranks}


def finish_data_parallel(workdir: str, card: str, started: dict) -> None:
    """Wait for the torchrun run (its checks) and the rank pair: a rank that
    fails or outlives 900 s fails the step, and every rank is killed."""
    from isaacgymenvs_tpu_torch.parallel import distributed

    started["torchrun_result"] = train_main_torchrun(workdir, card, started["torchrun"])
    codes = distributed.wait_ranks(started["ranks"], timeout=900)
    if any(codes):
        raise AssertionError(f"ranks exited {codes}:\n" + "\n".join(
            open(os.path.join(workdir, f"rank{r}.log")).read()[-3000:] for r in range(DP_RANKS)))
    started["rank_results"] = [torch.load(os.path.join(workdir, f"rank{r}.pt"), map_location="cuda",
                                          weights_only=False) for r in range(DP_RANKS)]


def rollout_gap(ranks, one, key) -> str:
    """Where the two ranks' own rollouts part from one process's: each
    env's largest reward gap over the horizon (the ranks' blocks side by
    side against the one process's envs)."""
    two = torch.cat([r[key]["own"]["reward"].cpu() for r in ranks], dim=1)
    gap = (two - one[key]["reward"].cpu()).abs().amax(0)
    top = torch.topk(gap, 3)
    return (f"reward gap per env over the horizon: largest {float(top.values[0]):.3e} (envs "
            + ", ".join(f"{int(i)}: {float(v):.3e}" for v, i in zip(top.values, top.indices))
            + f"), median {float(gap.median()):.3e}, envs above 1e-4: {int((gap > 1e-4).sum())} of {gap.numel()}")


def data_parallel(card: str, sizes: dict, started: dict) -> dict:
    """Steps 72-74's checks (but the NCCL one's) on the results of
    `start_data_parallel` and `finish_data_parallel`; returns the ranks'
    launches and the epoch times."""
    ref, torchrun, ranks = started["ref"], started["torchrun_result"], started["rank_results"]
    r0, r1 = ranks
    bad = []
    for key in (*DP_CASES, "lstm"):
        runs = ("own", "same") if key != "lstm" else (None,)
        pair = [(r0[key] if run is None else r0[key][run], r1[key] if run is None else r1[key][run]) for run in runs]
        same = True
        for a, b in pair:  # params and metrics bit-equal across the ranks
            same &= all(torch.equal(a["params"][k], b["params"][k]) for k in a["params"])
            same &= {k: v for k, v in a["metrics"].items() if k not in ("fps", "time")} == \
                {k: v for k, v in b["metrics"].items() if k not in ("fps", "time")}
            same &= all(np.isfinite(a["metrics"][k]) for k in DP_KEYS)
        a, b = pair[0]
        same &= a["launches"] == b["launches"] > 0
        sec = max(a["sec"], b["sec"])
        two = f"epoch {sec:.3f} s = {r0[key]['batch'] / sec:.1f} env-steps/s (beside steps 44-45 and torchrun's ranks)"
        if key == "lstm":  # from each rank's own reset and draws: the ranks agree with each other
            print(f"PPORecurrent (AnymalTerrainPPO_LSTM, local_shuffle) on {DP_RANKS} ranks ({a['num_envs']} envs "
                  f"each): params and metrics bit-equal across the ranks {same}; kl {a['metrics']['kl']:.5f}; {two} "
                  f"({card}); launches {a['launches']} + {b['launches']}")
            bad += [] if same else [(key, same)]
            continue
        one, own, on = ref[key], r0[key]["own"], r0[key]["same"]
        local, noise_key, perms_key = DP_CASES[key]
        # the epoch on the one process's rollout: the learner's math over the ranks (the global batch's moments,
        # the minibatch rows each rank holds, the all-reduce) against one process's, at DP_TOL
        far = {k: (on["metrics"][k], one["metrics"][k]) for k in DP_KEYS
               if not np.isclose(on["metrics"][k], one["metrics"][k], **DP_TOL)}
        # its first minibatch step, both sides at the same parameters and rows: the gradient the optimizer took,
        # against the float64 gradient of the one process's minibatch, and the parameters after the step
        g1, g64, gr = (x.cpu().double() for x in (one["grad"], one["grad64"], on["grad"]))
        p1, pr = one["params_first"].cpu(), on["params_first"].cpu()
        err_one, err_two = float((g1 - g64).abs().max()), float((gr - g64).abs().max())
        p_gap, p_close = float((pr - p1).abs().max()), bool(torch.allclose(pr, p1, **DP_TOL))
        scale = 2.0 ** -23 * float(g64.abs().max())  # one float32 eps of the largest element
        grad_ok = err_two <= DP_GRAD_EPS * scale
        # the epoch from each side's own rollout: the rollouts part (rollout_gap); the reward held at DP_TOL, the
        # losses held for the cases of DP_OWN_HELD
        far_own = {k: (own["metrics"][k], one["metrics"][k]) for k in DP_KEYS
                   if (k == "reward_mean_step" or key in DP_OWN_HELD)
                   and not np.isclose(own["metrics"][k], one["metrics"][k], **DP_TOL)}
        resets = own["metrics"]["n_episodes"], one["metrics"]["n_episodes"]
        gap = lambda run: max(float((r0[key][run]["params"][k].cpu() - one["params"][k].cpu()).abs().max())
                              for k in one["params"])
        print(f"{key} ({'local_shuffle' if local else 'global shuffle'}, the noise of {noise_key}, the permutations "
              f"of {perms_key}): {DP_RANKS} ranks ({r0[key]['num_envs']} envs each) against one process; params and "
              f"metrics bit-equal across the ranks {same}; on the one process's rollout: "
              + ", ".join(f"{k} {on['metrics'][k]:.7g} / {one['metrics'][k]:.7g}" for k in DP_KEYS)
              + f", largest parameter gap after the epoch {gap('same'):.3e}; its first minibatch step: gradient gap "
              f"to float64 {err_two:.3e} = {err_two / scale:.2f} eps on {DP_RANKS} ranks, {err_one:.3e} = "
              f"{err_one / scale:.2f} eps in one process (eps of the largest element {scale:.3e}, gap between the "
              f"two {float((gr - g1).abs().max()):.3e}), parameter gap after it {p_gap:.3e}; from each side's own "
              "rollout: "
              + ", ".join(f"{k} {own['metrics'][k]:.7g} / {one['metrics'][k]:.7g}" for k in DP_KEYS)
              + f", largest parameter gap after the epoch {gap('own'):.3e}, {rollout_gap(ranks, ref, key)}; episodes "
              f"ended {resets}; {two} on {DP_RANKS} ranks, one process {one['sec']:.3f} s = "
              f"{r0[key]['batch'] / one['sec']:.1f} env-steps/s ({card}); launches {own['launches']} + "
              f"{r1[key]['own']['launches']}")
        if not same or far or not grad_ok or not p_close or far_own or resets != (0, 0):
            print(f"{key}: each minibatch step's (a_loss, c_loss, kl, lr) on the one process's rollout, {DP_RANKS} "
                  f"ranks: {on['metrics']['steps']}; one process: {one['metrics']['steps']}")
            bad.append((key, same, far, grad_ok, p_close, far_own, resets))

    # ADR: every update bit-equal across the ranks and equal to one process's on the gathered inputs
    from isaacgymenvs_tpu_torch.dr.adr import AdrState

    ref_env = hand_env("AllegroHandDextremeADR", DEX_ENVS, FORCED_ADR)
    recs = [r["adr"]["records"] for r in ranks]
    moved = 0
    for step, (a, b) in enumerate(zip(*recs)):
        pre = a["pre"]
        st = AdrState(**{k: pre[k] for k in ("lo", "hi", "queues", "counts", "worker_boundary", "nats")})
        want = ref_env.adr.update(st, None, pre["done"], pre["objective"], fresh_workers=pre["fresh"]).as_dict()
        for f in ("lo", "hi", "queues", "counts", "nats"):
            if not (torch.equal(a["post"][f], b["post"][f]) and torch.equal(a["post"][f], want[f])):
                bad.append(("adr", step, f))
        wb = torch.cat([a["post"]["worker_boundary"], b["post"]["worker_boundary"]])
        if not torch.equal(wb, want["worker_boundary"]) or not torch.equal(pre["fresh"], b["pre"]["fresh"]):
            bad.append(("adr", step, "worker_boundary"))
        moved += int(not torch.equal(a["post"]["lo"], pre["lo"]) or not torch.equal(a["post"]["hi"], pre["hi"]))
    print(f"ADR over {DP_RANKS} ranks (AllegroHandDextremeADR, {DEX_ENVS} envs, {ranks[0]['adr']['num_envs']} each, "
          f"{len(recs[0])} forced updates): ranges, queues, counts and nats bit-equal across the ranks and equal to "
          f"one process's update on the gathered inputs in every update: {not any(x[0] == 'adr' for x in bad)}; "
          f"ranges moved in {moved} update(s); launches {[r['adr']['launches'] for r in ranks]}")
    new = {tuple(s) for r in ranks for s in r["instantiations"]} - {tuple(s) for s in sizes.values()}
    print(f"torchrun checkpoint restored bit for bit on both ranks: {[r['restored'] for r in ranks]}; backend "
          f"{r0['backend']}; instantiations the ranks loaded that no single-process step built: {sorted(new)}")
    if bad or not moved or new or not all(r["restored"] for r in ranks) or not all(r["adr"]["finite"] for r in ranks):
        raise AssertionError(f"data parallelism on {DP_RANKS} ranks: {bad[:8]}, ADR moved {moved}, new {new}")
    return {"launches": sum(r[k]["own"]["launches"] for r in ranks for k in DP_CASES),
            "launches_lstm": sum(r["lstm"]["launches"] for r in ranks),
            "launches_adr": sum(r["adr"]["launches"] for r in ranks),
            "two_rank_epoch_s": max(r["ant"]["own"]["sec"] for r in ranks), "one_process_epoch_s": ref["ant"]["sec"],
            "torchrun_s": torchrun["sec"]}


def nccl_one_rank(card: str) -> int:
    """Step 74b: one Ant epoch at 4,096 envs in a process group of one rank
    under NCCL: the epoch goes through the group's collectives (parameter
    broadcast, moment gathers, the gradient all-reduce of every minibatch,
    the metrics' gather) on the card. Returns its launches."""
    import torch.distributed as dist

    from isaacgymenvs_tpu_torch.parallel import distributed

    # maybe_initialize forms no group at world size 1 (as the JAX package's), so the step forms it itself
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{distributed.free_port()}", world_size=1, rank=0)
    try:
        agent = dp_agent(DP_ANT)
        if not agent.sharded or distributed.backend() != "nccl":
            raise AssertionError("the epoch does not go through the NCCL group")
        res = timed_epoch(agent, agent.init())
    finally:
        distributed.shutdown()
    metrics, launches, sec = res["metrics"], res["launches"], res["sec"]
    ok = launches == HORIZON and all(np.isfinite(metrics[k]) for k in DP_KEYS) and all(
        bool(torch.isfinite(p).all()) for p in res["params"].values())
    print(f"NCCL, one rank: one Ant epoch at {NUM_ENVS} envs through the group's collectives in {sec:.3f} s "
          f"({card}), {launches} launches, kl {metrics['kl']:.5f}")
    if not ok:
        raise AssertionError(f"the NCCL epoch: {launches} launches, metrics {metrics}")
    return launches


# ---- FactoryTaskGears (row 1ai) on both routes, and the eager engine's other cases ----

GEARS = "FactoryTaskGears"
GEARS_ENVS = 128  # numEnvs of FactoryTaskGears.yaml
GEARS_HORIZON = 32  # horizon_length of FactoryTaskGearsPPO.yaml
# the size tuple but for the envs per block: 3 x 40 gear points, each a plane row and an SDF row against the
# base's grid, the cap of 96 (three slots per lane), q_target
GEARS_SIZES = (16, 30, 27, 120, 0, 0, 1, 0, 0, 0, 0, 96, 0, 120)
GEARS_STEPS = 3  # env steps of the comparisons (controlFrequencyInv 1: one physics call each)
EAGER = "task.sim.use_fused=False"
# the plug of FactoryTaskInsertion scaled per env: per-env candidate points against the socket's SDF grid
PLUG_SCALE = {"actor_params": {"plug": {"scale": {"range": [0.95, 1.05], "operation": "scaling",
                                                  "distribution": "uniform", "setup_only": True}}}}
EAGER_OK = [False]  # True while a step drives the eager route on purpose (steps 76-77)


def watch_routes() -> None:
    """From here on every env this process resets must take the kernel
    route, but inside `eager_route()`."""
    from isaacgymenvs_tpu_torch.envcore.vec_task import VecTask

    reset = VecTask.reset

    def checked(self, *args, **kwargs):
        if not EAGER_OK[0] and self.physics_route != "kernel":
            raise AssertionError(f"{type(self).__name__} took the {self.physics_route} route: "
                                 f"{self.kernel_refusals()}")
        return reset(self, *args, **kwargs)

    VecTask.reset = checked


@contextmanager
def eager_route():
    EAGER_OK[0] = True
    try:
        yield
    finally:
        EAGER_OK[0] = False


def env_of(task: str, n: int, overrides=(), randomization=None, cls=None):
    """`task` from its yaml at n envs under `overrides`; with `randomization`
    domain randomization on with those specs; `cls` in place of the task's class."""
    from isaacgymenvs_tpu_torch.tasks import task_map
    from isaacgymenvs_tpu_torch.utils.config import load_config

    cfg = load_config([f"task={task}", f"num_envs={n}", *overrides])["task"]
    if randomization is not None:
        cfg["task"] = {"randomize": True, "randomization_params": randomization}
    return (cls or task_map[task])(cfg, device="cuda")


def gears_calls(env, q, qd):
    """One env step's physics inputs at (q, qd): the template's gravity
    compensation of the Franka and its PD setpoints at its own pose, and the
    SDF planes at the entry."""
    qfrc, xfrc, qt = env.compute_force(None, q, qd, {"q_ref": q[:, env.q_idx]})
    return qfrc, xfrc, qt, sdf_planes(env.model, q, qd)


def compare_gears(card: str):
    """Row 1ai against its plain version at the yaml's 128 envs for
    GEARS_STEPS env steps, each call under `gears_calls` at the plain
    output of the one before, from `industreal_inputs` on the task's
    `contact_states` (every gear on the table, or on its shaft on the
    plate); prints the size tuple, envs per block, shared memory, registers
    and spills. Returns the largest error and the compared states."""
    from isaacgymenvs_tpu_torch.engine import _cuda, fused

    env = env_of(GEARS, GEARS_ENVS)
    if env.physics_route != "kernel":
        raise AssertionError(f"{GEARS}: route {env.physics_route}")
    m, p = env.model, env.sim_params
    s = fused._extract(m)
    _, step = fused._prepared(m, p, torch.device("cuda"), True)
    figs = _cuda.ptxas_figures(_cuda.PTXAS_LOG.get(tuple(step.sizes), ""))
    print(f"{GEARS} row 1ai: sizes {'_'.join(map(str, step.sizes))}, {step.epb} envs per block, "
          f"{step.smem_bytes} bytes of shared memory per block, ptxas {figs['registers']} registers, "
          f"{figs['spill_stores']} bytes spill stores, {figs['spill_loads']} bytes spill loads ({card})")
    (q, qd), share, (most, mean, fewest) = industreal_inputs(env, GEARS_ENVS, seed=191, calls=GEARS_STEPS,
                                                             call_fn=gears_calls)
    plain = fused._step_math_torch(s, p, torch.device("cuda"))
    gear_bodies = [r.body0 for r in env.gear_refs]
    worst, x = 0.0, (q, qd)
    for call in range(GEARS_STEPS):
        qfrc, xfrc, qt, sdf = gears_calls(env, *x)
        ko = fused.physics_step_fused(m, p, x[0], x[1], qfrc, xfrc=xfrc, q_target=qt, sdf=sdf)
        po = plain(rows(x[0]), rows(x[1]), rows(qfrc), xfrc_rows(xfrc), rows(qt), None, None, 0, sdf)
        err = compare_outputs(f"{GEARS} call {call}", ko, po, s.nbody, GEARS_ENVS)
        worst = max(worst, *err.values())
        if call == 0:
            force = torch.linalg.vector_norm(ko.body_force[:, gear_bodies], dim=-1)
            on_gears = float((force > 0.01).all(1).float().mean())
            print(f"{GEARS} kernel vs plain, N={GEARS_ENVS}, call 0: {100 * share:.1f} % of the drawn contact "
                  f"states well conditioned over {GEARS_STEPS} calls, rows in the margin {mean:.2f} per env on "
                  f"average, {most} at most, {fewest} at fewest (cap 96 of {s.nct}), contact force on all three "
                  f"gears in {100 * on_gears:.1f} % of envs: {json.dumps(err)}")
            if not on_gears >= 0.5:
                raise AssertionError(f"{GEARS}: force on the gears in {on_gears:.3f} of the envs")
        x = (po[0].T.contiguous(), po[1].T.contiguous())
    print(f"{GEARS} kernel vs plain, N={GEARS_ENVS}, {GEARS_STEPS} env steps: largest error {worst:.3e} ({card})")
    return worst, (q, qd)


def gears_kernel_path(card: str, states) -> dict:
    """Row 1ai timed at 128 envs in the compared states (with its bound),
    env.step env-steps/s under random actions and device ops per env step
    on the kernel route, then `train.main` for 2 epochs, a bit-equal
    restore, a resume and play. Returns the kernel's times and the training
    launches."""
    from isaacgymenvs_tpu_torch.bench import measure

    env = env_of(GEARS, GEARS_ENVS)
    q, qd = states
    qfrc, xfrc, qt, sdf = gears_calls(env, q, qd)
    t = kernel_times(env, rows(q), rows(qd), rows(qfrc), xfrc_rows(xfrc), card, reps=30, qt=rows(qt), sdf=sdf)
    bench = measure(GEARS_ENVS, 4, reps=2, device="cuda", task=GEARS)
    ops = profile_env_step(env, steps=1, label=f"{GEARS} env.step (kernel route)")
    print(f"{GEARS} kernel route: env.step {bench['env_steps_per_s']:.1f} env-steps/s under random actions, "
          f"{ops:.1f} device ops per env step ({GEARS_ENVS} envs; {card})")
    launches = train_main_at_width(GEARS, GEARS_ENVS, GEARS_HORIZON, epochs=2)
    return {**t, "env_steps_per_s": bench["env_steps_per_s"], "device_ops_per_step": ops}, launches


def gears_eager(card: str, states) -> dict:
    """Step 76: FactoryTaskGears under sim.use_fused=False at 128 envs: the
    route is eager and the kernel's launch count stays; GEARS_STEPS eager
    steps in float32 against float64 on the card from the compared states,
    each from the float64 state, at TOL; env.step env-steps/s and device
    ops per env step; `train.main` for 2 epochs, a bit-equal restore, a
    resume and play, without a launch."""
    from isaacgymenvs_tpu_torch.engine import _cuda
    from isaacgymenvs_tpu_torch.engine.dynamics import SimState
    from isaacgymenvs_tpu_torch.engine.step import physics_step

    with eager_route():
        env = env_of(GEARS, GEARS_ENVS, (EAGER,))
        if env.physics_route != "eager":
            raise AssertionError(f"{GEARS} {EAGER}: route {env.physics_route}")
        m, p = env.model, env.sim_params
        torch.cuda.synchronize()
        _cuda.FusedStepCall.launches = 0
        q, qd = states
        worst = {k: 0.0 for k in TOL}
        for _ in range(GEARS_STEPS):
            qfrc, xfrc, qt, _ = gears_calls(env, q, qd)
            a = physics_step(m, SimState(q, qd), qfrc, p, xfrc=xfrc, q_target=qt)
            b = physics_step(m, SimState(q.double(), qd.double()), qfrc.double(), p, xfrc=xfrc.double(),
                             q_target=qt.double())
            for k in TOL:
                got, ref = (getattr(a.state, k), getattr(b.state, k)) if k in ("q", "qd") else \
                    (getattr(a, k), getattr(b, k))
                if not bool(torch.isfinite(got).all()):
                    raise AssertionError(f"{GEARS} eager: {k} is not finite")
                worst[k] = max(worst[k], float((got.double() - ref).abs().max()))
            q, qd = b.state.q.float(), b.state.qd.float()
        bad = {k: (e, TOL[k]) for k, e in worst.items() if not e < TOL[k]}
        print(f"{GEARS} eager engine, float32 against float64 on the card, N={GEARS_ENVS}, {GEARS_STEPS} steps: "
              f"{json.dumps(worst)} ({card})")
        if bad:
            raise AssertionError(f"{GEARS} eager: float32 parts from float64 {bad}")
        state, _ = env.reset(0)
        gen = torch.Generator(device="cuda").manual_seed(3)
        act = lambda: torch.rand(GEARS_ENVS, env.num_acts, generator=gen, device="cuda") * 2 - 1
        for _ in range(2):
            state, *_ = env.step(state, act())
        torch.cuda.synchronize()
        t0, reps = time.perf_counter(), 8
        for _ in range(reps):
            state, *_ = env.step(state, act())
        torch.cuda.synchronize()
        sps = reps * GEARS_ENVS / (time.perf_counter() - t0)
        if not bool(torch.isfinite(state.sim.q).all()):
            raise AssertionError(f"{GEARS} eager: the state is not finite")
        ops = profile_env_step(env, steps=1, label=f"{GEARS} env.step (eager route)")
        print(f"{GEARS} eager route: env.step {sps:.1f} env-steps/s under random actions, {ops:.1f} device ops per "
              f"env step ({GEARS_ENVS} envs; {card})")
        train_main_at_width(GEARS, GEARS_ENVS, GEARS_HORIZON, epochs=2, overrides=(EAGER,), eager=True)
        if _cuda.FusedStepCall.launches:
            raise AssertionError(f"{GEARS} eager: {_cuda.FusedStepCall.launches} kernel launches")
    return {"max_abs_err_f32_f64": worst, "env_steps_per_s": sps, "device_ops_per_step": ops}


def other_eager_cases(card: str) -> dict:
    """Step 77: BallBalance under sim.use_fused=False (anchors and a pair
    row) at 4096 envs, the pair-row example under `solver: pgs` at 4096,
    and FactoryTaskInsertion with its plug scaled per env at 128, a few
    steps each: the route eager, the state finite. Returns each case's
    seconds."""
    from isaacgymenvs_tpu_torch.engine import _cuda
    from isaacgymenvs_tpu_torch.engine.dynamics import SimParams, SimState
    from isaacgymenvs_tpu_torch.engine.step import physics_step
    from isaacgymenvs_tpu_torch.model.examples import pair_row_example, pair_row_example_state
    from isaacgymenvs_tpu_torch.tasks.factory_templates import FactoryTaskInsertion

    class InsertionWithPlug(FactoryTaskInsertion):
        def dr_actor_ranges(self):
            b = self.plug_ref.body0
            return {"plug": (b, b + 1)}

    secs = {}
    with eager_route():
        _cuda.FusedStepCall.launches = 0
        cases = {"BallBalance": lambda: env_of("BallBalance", 4096, (EAGER,)),
                 "FactoryTaskInsertion+plug_scale": lambda: env_of("FactoryTaskInsertion", 128,
                                                                   randomization=PLUG_SCALE, cls=InsertionWithPlug)}
        for name, make in cases.items():
            t0 = time.perf_counter()
            env = make()
            if env.physics_route != "eager":
                raise AssertionError(f"{name}: route {env.physics_route}")
            state, _ = env.reset(0)
            for _ in range(4):
                state, obs, *_ = env.step(state, torch.zeros(env.num_envs, env.num_acts, device="cuda"))
            if not (bool(torch.isfinite(state.sim.q).all()) and bool(torch.isfinite(obs).all())):
                raise AssertionError(f"{name} eager: the state is not finite")
            torch.cuda.synchronize()
            secs[name] = time.perf_counter() - t0
            print(f"{name} on the eager route ({'; '.join(env.kernel_refusals()) or 'sim.use_fused=False'}): 4 env "
                  f"steps at {env.num_envs} envs finite, {secs[name]:.2f} s with set-up ({card})")
        t0 = time.perf_counter()
        m, n = pair_row_example(), 4096
        q, qd = (torch.tensor(a, device="cuda") for a in pair_row_example_state(m, n, 1))
        p = SimParams(substeps=2, solver="pgs", contact_margin=0.02)
        for _ in range(4):
            out = physics_step(m, SimState(q, qd), torch.zeros_like(qd), p)
            q, qd = out.state.q, out.state.qd
        if not bool(torch.isfinite(q).all()) or not float(out.body_force.abs().max()) > 0:
            raise AssertionError("PGS example: the state is not finite or no contact acted")
        torch.cuda.synchronize()
        secs["pgs_example"] = time.perf_counter() - t0
        print(f"the pair-row example under solver pgs: 4 steps at {n} envs finite, {secs['pgs_example']:.2f} s ({card})")
        if _cuda.FusedStepCall.launches:
            raise AssertionError(f"the eager cases launched the kernel {_cuda.FusedStepCall.launches} times")
    return secs


def build_all():
    """Step 2: every instantiation's size tuple on this card, built with one
    nvcc each, each started as soon as its env is made; prints ptxas's
    figures, the shared memory per block and the residency the device grants
    each build. Returns (the Ant env at the main path's width, its spec, key
    -> (env, per-env leaf names), key -> size tuple)."""
    from isaacgymenvs_tpu_torch.engine import _cuda, fused

    def timed_build(size):
        t0 = time.perf_counter()
        _cuda.build(size, verbose=True)
        return time.perf_counter() - t0

    def params_of(t, e):
        return physics_args(e)[0] if t in ANYMAL_CASES else e.sim_params

    t_start = time.perf_counter()
    pool = ThreadPoolExecutor(64)
    sizes, builds = {}, {}

    class Built(dict):
        """key -> (env, per-env leaf names); each entry's build starts when it is set (envs per block from
        this card's shared memory)."""

        def __setitem__(self, t, entry):
            super().__setitem__(t, entry)
            e, names = entry
            sizes[t] = _cuda.instantiation(fused._extract(e.model), params_of(t, e), torch.device("cuda", 0),
                                           e.use_pd_targets, names, getattr(e, "terrain", None) is not None)[0]
            if sizes[t] not in builds:
                builds[sizes[t]] = pool.submit(timed_build, sizes[t])

    env = ant_env(NUM_ENVS)
    cart = cartpole_env(CARTPOLE_ENVS)
    s, s0 = fused._extract(env.model), fused._extract(cart.model)
    if s0.nct != 0 or s.nc == 0:
        raise AssertionError("Cartpole should be contact-free and the Ant not")
    built = Built()
    built["Ant"], built["Cartpole"] = (env, ()), (cart, ())
    for k in CASES:
        built[k] = case(k, 8)
    for k in ANYMAL_CASES:  # the per-env leaves of their own DR, the cap and terrain of their yaml
        e = anymal_env(k, 8)
        se = fused._extract(e.model)
        built[k] = (e, fused.dyn_names(se, e.randomizer.batched_leaf_names()) if e.randomizer is not None else ())
    built["Ball"] = (ball_holder(), ())  # the SDF rows (K6) without a cap
    built["Insertion"] = (insertion_env(8), ())  # SDF rows under the cap of 32, envs per block from its shared memory
    built["Humanoid"] = (humanoid_env(8), ())  # nv 27: 27 dof lanes, four k-tiles of the Gram product
    built["HumanoidAMP"] = (amp_env(8), ())  # nv 34: two dofs per lane, five k-tiles, the cap of 16, q_target
    for t in FRANKA_WIDTH:  # pair rows only (BOX; MESH on the cylinder branch) under caps of 20 and 16, q_target
        built[t] = (task_env(t, 8), ())
    for t in NUTBOLT_WIDTH:  # plane and SDF rows, two grids on moving bodies, under the cap of 16, q_target
        built[t] = (task_env(t, 8), ())
    for t in INDUSTREAL_WIDTH:  # plane and SDF rows under caps of 32 and 64 (Gears: three grids), q_target
        built[t] = (task_env(t, 8), ())
    for t in HAND_WIDTH:  # pair rows (Trifinger: and plane rows, its yaml's per-env leaves; the hands: the cap of 24)
        e = hand_env(t, 8)
        dyn = hand_dyn(e, 8, 0)
        built[t] = (e, () if dyn is None else dyn.names)
    e = hand_env(HAND_FF, 8)  # ShadowHand's build under its OpenAI variant's leaves and object force
    built[HAND_FF] = (e, hand_dyn(e, 8, 0).names)
    for t in KUKA_WIDTH:  # pair rows only, no cap, q_target; two arms: nv 52, 56 rows
        built[t] = (hand_env(t, 8), ())
    e = hand_env("AllegroKukaReorientation", 8, ("task.task.randomize=True",))  # the one arm under its yaml's DR
    built[KUKA_DR] = (e, hand_dyn(e, 8, 0).names)
    for t in DEX_WIDTH:  # AllegroHand's model (row 1ae) under each DeXtreme yaml's per-env leaves, drawn through ADR
        e = hand_env(t, 8)
        built[t] = (e, hand_dyn(e, 8, 0).names)
    built[GEARS] = (env_of(GEARS, 8), ())  # 240 rows under the cap of 96: three slots per lane
    made = time.perf_counter() - t_start

    # the size tuples the steps will take on this card
    if sizes["Quadcopter"][3] <= 32 or sizes["BallBalance"][4:7] != (1, 3, 1) or sizes["Example"][4] != 3 \
            or sizes["Ant+yaml"][7:] != (0, 115, 0, 0, 0, 0, 0, 4) \
            or sizes["Tendon+all"][7:] != (1, 65535, 10, 3, 0, 0, 0, 8) \
            or sizes["Anymal"] != (13, 19, 18, 44, 0, 0, 1, 0, 0, 0, 0, 0, 0, 0, 4) \
            or sizes["AnymalTerrain"] != (13, 19, 18, 44, 0, 0, 1, 0, 128, 44, 0, 20, 1, 0, 4) \
            or sizes["AnymalTerrain-plane"] != (13, 19, 18, 44, 0, 0, 1, 0, 128, 44, 0, 20, 0, 0, 4) \
            or sizes["Ball"] != (2, 7, 6, 1, 0, 0, 0, 0, 0, 0, 0, 0, 0, 1, 8) \
            or sizes["Insertion"] != (14, 16, 15, 64, 0, 0, 1, 0, 0, 0, 0, 32, 0, 64, 8) \
            or sizes["Humanoid"] != (25, 28, 27, 35, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 8) \
            or sizes["HumanoidAMP"] != AMP_SIZES \
            or any(sizes[t][:14] != FRANKA_SIZES[t] for t in FRANKA_WIDTH) \
            or any(sizes[t][:14] != NUTBOLT_SIZES[t] for t in NUTBOLT_WIDTH) \
            or any(sizes[t][:14] != INDUSTREAL_SIZES[t] for t in INDUSTREAL_WIDTH) \
            or any(sizes[t][:14] != HAND_SIZES[t] for t in (*HAND_WIDTH, HAND_FF)) \
            or any(sizes[t][:14] != KUKA_SIZES[t] for t in KUKA_SIZES) \
            or any(sizes[t][:8] + sizes[t][11:14] != HAND_SIZES["AllegroHand"][:8] + HAND_SIZES["AllegroHand"][11:14]
                   or not sizes[t][8] for t in DEX_WIDTH) \
            or sizes[GEARS][:14] != GEARS_SIZES \
            or len(set(sizes.values())) != len(sizes):
        raise AssertionError(f"unexpected size tuples {sizes}")
    secs = [builds[sz].result() for sz in sizes.values()]
    pool.shutdown()
    print(f"build: {time.perf_counter() - t_start:.1f} s in all, the envs made in the first {made:.1f} s; " + ", ".join(
        f"{t} {'_'.join(map(str, sz))} {sec:.1f} s" for (t, sz), sec in zip(sizes.items(), secs)))
    for t, (e, names) in built.items():
        if getattr(e, "physics_route", "kernel") != "kernel":
            raise AssertionError(f"{t}: the {e.physics_route} route ({e.kernel_refusals()})")
        has_t = getattr(e, "terrain", None) is not None
        _, step = fused._prepared(e.model, params_of(t, e), torch.device("cuda"), e.use_pd_targets, names, has_t)
        if step.sizes != sizes[t]:
            raise AssertionError(f"{t}: the step took {step.sizes}, not the built {sizes[t]}")
        occ = step.occupancy()
        figs = _cuda.ptxas_figures(_cuda.PTXAS_LOG.get(sizes[t], ""))
        print(f"shared memory per block, {t}: {step.smem_bytes} bytes ({step.epb} envs; the limit of one block "
              f"is {step.smem_limit}), {step.dyn_rows} per-env rows; ptxas {figs['registers']} registers, "
              f"{figs['spill_stores']} bytes spill stores, {figs['spill_loads']} bytes spill loads; the device "
              f"keeps {occ['blocks_per_sm']} blocks ({occ['blocks_per_sm'] * step.epb} warps) resident per SM at "
              f"{occ['registers']} registers per thread, {occ['local_bytes']} local bytes (host plan: "
              f"{_cuda.resident_blocks(step.smem_bytes, step.epb, _cuda.plan_regs(step.s.nv))} blocks at "
              f"{_cuda.plan_regs(step.s.nv)} registers)")
        if occ["blocks_per_sm"] < 1 or occ["smem_bytes"] != step.smem_bytes:
            raise AssertionError(f"{t}: occupancy {occ} for a block of {step.smem_bytes} bytes")
    return env, s, built, sizes


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from isaacgymenvs_tpu_torch.engine import _cuda, fused
    from isaacgymenvs_tpu_torch.learn import PPO

    # 1. the card
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi)
    name = torch.cuda.get_device_name(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    watch_routes()
    t_start = time.perf_counter()
    lap = lambda step: print(f"[{time.perf_counter() - t_start:.1f} s] steps up to {step} done")

    # 2. build every instantiation, one nvcc each, started together
    env, s, built, sizes = build_all()
    lap(2)

    # 3. kernel vs plain version
    if any(RAGGED_ENVS % e == 0 for e in _cuda.ENVS_PER_BLOCK_CHOICES if e > 1):
        raise AssertionError(f"N={RAGGED_ENVS} fills every block of some envs-per-block choice")
    err_ragged = compare(ant_env(RAGGED_ENVS), steps=3, seed=1)
    print(f"kernel vs plain, N={RAGGED_ENVS}, 3 steps:", json.dumps(err_ragged))
    err_main = compare(env, steps=1, seed=2)
    print(f"kernel vs plain, N={NUM_ENVS}, 1 step:", json.dumps(err_main))
    max_err = max(max(err_ragged.values()), max(err_main.values()))
    max_err0 = 0.0
    for n, steps in ((RAGGED_ENVS, 3), (NUM_ENVS, 1), (CARTPOLE_ENVS, 1)):
        e = compare(cartpole_env(n), steps=steps, seed=1, qfrc_max=100.0, with_xfrc=False)
        print(f"contact-free kernel vs plain, N={n}, {steps} step(s):", json.dumps(e))
        max_err0 = max(max_err0, *e.values())
    lap(3)

    # 4. the main path: a PPO rollout on the Ant VecTask
    train = {"network": {"mlp": {"units": [256, 128, 64], "activation": "elu"}},
             "config": {"horizon_length": HORIZON, "value_bootstrap": True}}
    agent = PPO(env, train, seed=0)
    ts = agent.init()
    ts, _, _ = agent.rollout(ts)  # warm-up
    torch.cuda.synchronize()
    _cuda.FusedStepCall.launches = 0
    t0 = time.perf_counter()
    ts, traj, last_value = agent.rollout(ts)
    torch.cuda.synchronize()
    sec = time.perf_counter() - t0
    launches = _cuda.FusedStepCall.launches
    if launches != HORIZON * env.control_freq_inv:
        raise AssertionError(f"{launches} kernel launches for {HORIZON} env steps")
    for k in ("obs", "action", "logp", "value", "reward"):
        if not bool(torch.isfinite(getattr(traj, k)).all()):
            raise AssertionError(f"rollout {k} is not finite")
    if not bool(torch.isfinite(last_value).all()) or not bool(torch.isfinite(ts.env_state.sim.q).all()):
        raise AssertionError("rollout state is not finite")
    if tuple(traj.obs.shape) != (HORIZON, NUM_ENVS, env.num_obs):
        raise AssertionError(f"rollout obs shape {tuple(traj.obs.shape)}")
    rollout_sps = HORIZON * NUM_ENVS / sec
    print(f"rollout: {HORIZON} steps x {NUM_ENVS} envs in {sec:.4f} s = {rollout_sps:.1f} env-steps/s "
          f"(policy + env), {launches} launches, mean reward {float(traj.reward.mean()):.4f}")

    # settle under zero actions: the feet carry about the Ant's weight
    state, obs = env.reset(3)
    zero = torch.zeros(NUM_ENVS, env.num_acts, device="cuda")
    for _ in range(60):
        state, obs, _, _, _ = env.step(state, zero)
    weight = float(np.sum(env.model.body_mass)) * 9.81
    feet_fz = obs[:, 28:52].reshape(NUM_ENVS, 4, 6)[:, :, 2].sum(1) / env.contact_force_scale
    ratio = float(feet_fz.mean()) / weight
    print(f"settled feet fz / weight: {ratio:.4f} (mean over {NUM_ENVS} envs)")
    if not 0.5 < ratio < 2.0:
        raise AssertionError(f"settled foot force {ratio:.3f} x weight")
    lap(4)

    # 5. kernel time at the main path's shapes (the rollout's last state)
    from isaacgymenvs_tpu_torch.bench import measure

    bench = measure(NUM_ENVS, HORIZON, reps=8, device="cuda")
    print(f"env.step under random actions: {bench['env_steps_per_s']:.1f} env-steps/s")
    ops_plain = profile_env_step(env)
    q, qd = rows(ts.env_state.sim.q), rows(ts.env_state.sim.qd)
    qfrc = rows(env.qfrc_from_actuators(torch.clamp(traj.action[-1], -1, 1)))
    xfrc = torch.zeros(6 * s.nbody, NUM_ENVS, device="cuda")
    ant_t = kernel_times(env, q, qd, qfrc, xfrc, name)
    lap(5)

    # 6. the training path on Ant, 7. on Cartpole
    train_launches = train_epochs()
    lap(6)
    cart_launches = train_cartpole()
    lap(7)

    # 8. the contact-free kernel at its training path's width and at 4096 envs
    cart_t = {}
    for n in (CARTPOLE_ENVS, NUM_ENVS):
        cenv = cartpole_env(n)
        state, _ = cenv.reset(6)
        gen = torch.Generator(device="cuda").manual_seed(7)
        act = torch.rand(n, 1, generator=gen, device="cuda") * 2 - 1
        cart_t[n] = kernel_times(cenv, rows(state.sim.q), rows(state.sim.qd),
                                 rows(cenv.compute_force(act, None, None, ())[0]), None, name)

    lap(8)
    # 9. the new instantiations against their plain versions
    new_err = {t: compare_case(t) for t in NEW_CASES}
    lap(9)

    # 10. physical checks: BallBalance's anchors and tray force, the example model's spheres
    settle_ball_balance(NEW_TASKS["BallBalance"][0])
    new_launches = {"Example": settle_example(NUM_ENVS)}
    lap(10)

    # 11. one timed full-width epoch per new task after a warm-up, 12. BallBalance through train.main
    conf = {"Ingenuity": (16384, 8), "Quadcopter": (16384, 8), "BallBalance": (8192, 8)}
    for t, (envs, horizon) in NEW_TASKS.items():
        new_launches[t] = train_epochs(t, (envs, horizon, envs * horizon, *conf[t]), profile=t == "BallBalance")
        bench = measure(envs, horizon, reps=4, device="cuda", task=t)
        print(f"{t} env.step under random actions: {bench['env_steps_per_s']:.1f} env-steps/s")
    lap(11)
    new_launches["BallBalance"] += train_ball_balance()
    lap(12)

    # 13. kernel times of the new instantiations at full width
    new_t = {t: time_case(t, name) for t in NEW_CASES}
    lap(13)

    # 14. per-env leaves and tendons: against the plain version and the step without leaves, then timed
    dyn_err = {k: compare_case(k) for k in DYN_CASES}
    dyn_t = {k: time_case(k, name) for k in DYN_CASES}
    lap(14)

    # 15. physical checks, and the instantiations no task drives yet through physics_step_fused
    dyn_launches = {"Ant+all": free_fall_under_per_env_gravity(NUM_ENVS)}
    settle_ant_with_randomized_mass(NUM_ENVS)
    for k in ("Tendon", "Tendon+all", "BallBalance+pair"):
        dyn_launches[k] = drive_case(k)
    lap(15)

    # 16. the DR main path: Ant with task.randomize=True at full width
    ops_dr = profile_env_step(task_env("Ant", NUM_ENVS, randomize=True), label="env.step task.randomize=True")
    print(f"device ops per Ant env step: {ops_plain:.1f} without domain randomization, {ops_dr:.1f} with")
    bench = measure(NUM_ENVS, HORIZON, reps=8, device="cuda", randomize=True)
    print(f"Ant task.randomize=True env.step under random actions: {bench['env_steps_per_s']:.1f} env-steps/s")
    dyn_launches["Ant+yaml"] = train_epochs("Ant", overrides=("task.randomize=True",)) + train_ant_randomized()
    dyn_launches.update({f"{t}+dr": n for t, n in step_randomized_tasks().items()})

    lap(16)
    # 17. Anymal and AnymalTerrain: the three instantiations against their plain versions
    anymal_err = {k: compare_anymal(k) for k in ANYMAL_CASES}
    lap(17)
    # 18. one merged window against four separate launches
    merged_vs_separate()
    lap(18)
    # 19. physical checks: standing on flat ground, every terrain type, the curriculum
    settle_anymal()
    terrain_types_and_curriculum()
    lap(19)
    # 20. the training path at full width: 1 + 1 epochs each, AnymalTerrain through train.main, the plane variant
    anymal_launches = {
        "Anymal": train_epochs("Anymal", (ANYMAL_ENVS, 24, 98304, 32768, 5), profile=False),
        "AnymalTerrain": train_epochs("AnymalTerrain", (ANYMAL_ENVS, 24, 98304, 16384, 5), profile=False),
    }
    ops_terrain = profile_env_step(anymal_env("AnymalTerrain", ANYMAL_ENVS), label="AnymalTerrain env.step")
    print(f"device ops per AnymalTerrain env step: {ops_terrain:.1f}")
    anymal_launches["AnymalTerrain"] += train_anymal_terrain()
    anymal_launches["AnymalTerrain-plane"] = drive_plane()
    lap(20)
    # 21. kernel times at full width
    anymal_t = {k: time_anymal(k, name) for k in ANYMAL_CASES}

    lap(21)
    # 22. FactoryTaskInsertion and the ball on an SDF box against their plain versions
    sdf_err = {"Insertion": compare_insertion(), "Ball": compare_ball()}
    lap(22)
    # 23. the ball rests on the SDF box
    sdf_launches = {"Ball": settle_ball()}
    lap(23)
    # 24. the training path at the yaml's width: 1 + 1 epochs, device ops per env step, train.main
    sdf_launches["Insertion"] = train_epochs("FactoryTaskInsertion", INSERTION_WIDTH, profile=False)
    ops_ins = profile_env_step(insertion_env(INSERTION_ENVS), label="FactoryTaskInsertion env.step")
    print(f"device ops per FactoryTaskInsertion env step: {ops_ins:.1f}")
    sdf_launches["Insertion"] += train_insertion()
    lap(24)
    # 25. kernel times
    sdf_t = {"Insertion": time_insertion(name), "Ball": time_ball(name)}

    lap(25)
    # 26. Humanoid (nv 27, K1 + K2) against its plain version
    humanoid_err = compare_humanoid()
    lap(26)
    # 27. Humanoid PPO at full width: 1 + 1 epochs, device ops per env step
    humanoid_launches = {"PPO": train_epochs("Humanoid", HUMANOID_WIDTH, profile=False)}
    ops_humanoid = profile_env_step(humanoid_env(HUMANOID_ENVS), label="Humanoid env.step")
    print(f"device ops per Humanoid env step: {ops_humanoid:.1f}")
    lap(27)
    # 28. Humanoid SAC at full width
    humanoid_launches["SAC"] = train_humanoid_sac()
    lap(28)
    # 29. the four recipes through train.main: train; resume and play for one per learner
    recipe_launches = train_main_recipes()
    lap(29)
    # 30. AnymalTerrain with the LSTM: 1 + 1 epochs
    lstm_launches = train_epochs("AnymalTerrain", LSTM_WIDTH, profile=False, recipe="AnymalTerrainPPO_LSTM",
                                 check=lstm_carry_check)
    lap(30)
    # 31. two rollouts from one seed are bit-equal
    determinism()
    lap(31)
    # 32. the Humanoid kernel timed
    humanoid_t = time_humanoid(name)

    lap(32)
    # 33. HumanoidAMP (nv 34, VPL 2, the cap of 16, q_target) against its plain version
    amp_err = compare_amp()
    lap(33)
    # 34. AMP at full width: 1 + 1 epochs
    amp_launches = {"epochs": train_epochs("HumanoidAMP", AMP_WIDTH, profile=False)}
    ops_amp = profile_env_step(amp_env(AMP_ENVS), label="HumanoidAMP env.step")
    print(f"device ops per HumanoidAMP env step: {ops_amp:.1f}")
    lap(34)
    # 35. train.main task=HumanoidAMP: train, restore bit-equal, resume, play; 36. HRL on HumanoidAMP
    amp_launches["train_main"] = train_main_amp()
    lap(35)
    hrl = train_main_hrl()
    amp_launches.update(hrl_macro_step=hrl["macro"], hrl_train_main=hrl["train"])
    lap(36)
    # 37. the HumanoidAMP kernel timed
    amp_t = time_amp(name)
    lap(37)
    # 38. FrankaCubeStack and FrankaCabinet against their plain versions
    franka_err = {t: compare_franka(t) for t in FRANKA_WIDTH}
    lap(38)
    # 39. FrankaCubeStack's OSC on the card
    osc_on_card()
    lap(39)
    # 40. 1 + 1 full-width PPO epochs of each, FrankaCubeStack's device ops per env step with the OSC's share
    franka_launches = {t: {"epochs": train_epochs(t, FRANKA_WIDTH[t], profile=False)} for t in FRANKA_WIDTH}
    osc_share()
    lap(40)
    # 41. train.main for each: train, restore bit-equal
    for t in FRANKA_WIDTH:
        franka_launches[t]["train_main"] = train_main_at_width(t, *FRANKA_WIDTH[t][:2], resume=False, play=False)
    lap(41)
    # 42. both kernels timed
    franka_t = {t: time_franka(t, name) for t in FRANKA_WIDTH}
    lap(42)
    # 72-74 (but NCCL) started: the one-process epochs, then torchrun's train.main and the rank pair beside
    # steps 44-45, whose results hang on no clock; both waited for before step 46's timings
    dp_dir = tempfile.TemporaryDirectory()
    torch.cuda.empty_cache()  # the card's memory for the four processes beside
    dp_started = start_data_parallel(dp_dir.name)
    lap("72-74 started")
    # 44. the nut-bolt family (rows 1x-1z) against their plain versions
    nutbolt_err = {t: compare_nutbolt(t) for t in NUTBOLT_WIDTH}
    lap(44)
    # 45. the behaviour of the JAX package's slow tests, through the kernel
    nutbolt_launches = {t: {} for t in NUTBOLT_WIDTH}
    nutbolt_launches["FactoryTaskNutBoltScrew"]["free_nut"] = free_nut_on_threads()
    nutbolt_launches["FactoryTaskNutBoltPlace"]["grip_and_carry"] = place_grip_and_carry()
    nutbolt_launches["FactoryTaskNutBoltScrew"]["press_and_rotate"] = screw_press_and_rotate()
    lap(45)
    finish_data_parallel(dp_dir.name, smi, dp_started)  # nothing runs beside the timings that follow
    lap("72-74 waited for")
    # 46. NutBoltPick's device ops and busy share per env step (the epoch at the yaml's width is step 47's)
    t = "FactoryTaskNutBoltPick"
    ops = profile_env_step(task_env(t, NUTBOLT_ENVS), label=f"{t} env.step")
    print(f"device ops per {t} env step: {ops:.1f}")
    lap(46)
    # 47. train.main task=FactoryTaskNutBoltPick, one timed epoch at the yaml's width: train, restore bit-equal
    nutbolt_launches[t]["train_main"] = train_main_at_width(t, *NUTBOLT_WIDTH[t][:2], epochs=1, resume=False,
                                                            play=False)
    lap(47)
    # 48. the three kernels timed at 128 and 4096 envs
    nutbolt_t = {t: time_nutbolt(t, name) for t in NUTBOLT_WIDTH}
    lap(48)
    # 49. IndustReal (PegsInsert: cap 32; GearsInsert: cap 64, three grids) against their plain versions
    industreal_err = {t: compare_industreal(t) for t in INDUSTREAL_WIDTH}
    lap(49)
    # 50. the behaviour of the JAX package's slow IndustReal tests, through the kernel
    industreal_launches = {t: {"bars": n} for t, n in industreal_bars().items()}
    lap(50)
    # 51. env-steps/s, device ops per env step and the reset's IK at the yaml's 128 envs
    for t in INDUSTREAL_WIDTH:
        industreal_env_step(t, profile=t == "IndustRealTaskPegsInsert")
    lap(51)
    # 52. train.main on PegsInsert (2 epochs: SBC acts once; restore), one GearsInsert epoch (its update cut)
    industreal_launches["IndustRealTaskPegsInsert"]["train_main"] = industreal_train_main()
    industreal_launches["IndustRealTaskGearsInsert"]["epoch"] = gears_epoch()
    lap(52)
    # 53. both kernels timed at 128 and 4096 envs
    industreal_t = {t: time_industreal(t, name) for t in INDUSTREAL_WIDTH}
    lap(53)
    # 54. Trifinger, ShadowHand and AllegroHand (rows 1ac-1ae) against their plain versions; ShadowHand's build
    # under its OpenAI variant's leaves and object force
    hand_err = {t: compare_hand(t) for t in HAND_WIDTH}
    ff_err = compare_hand(HAND_FF, steps=1)
    lap(54)
    # 55. the behaviour of the JAX package's hand tests, through the kernel at 16,384 envs
    hand_launches = {t: {"bars": n} for t, n in hand_bars().items()}
    lap(55)
    # 56. env-steps/s (ShadowHand's device ops per env step); one PPO epoch after a warm-up, at the yaml's width
    for t in HAND_WIDTH:
        hand_env_step(t, profile=t == "ShadowHand")
        hand_launches[t]["epochs"] = train_epochs(t, HAND_WIDTH[t], profile=False)
    lap(56)
    # 57. the three kernels timed at 16,384 envs
    hand_t = {t: time_hand(t, name) for t in HAND_WIDTH}
    lap(57)
    # 58. AllegroKuka, one arm and two arms (rows 1af, 1ag), against their plain versions at N=1003 (2 env
    # steps) and 8,192 (one); the one arm under its yaml's domain randomization (row 1af') for one
    kuka_err = {k: compare_kuka(k) for k in (*KUKA_WIDTH, KUKA_DR)}
    lap(58)
    # 59. the JAX package's cube-rest bars through the kernel at 8,192 envs
    kuka_launches = {t: {"bars": cube_at_rest(t)["launches"]} for t in KUKA_WIDTH}
    lap(59)
    # 60. env-steps/s (one arm's device ops and busy share per env step); one PPO epoch after a warm-up at the
    # yaml's width
    for t in KUKA_WIDTH:
        kuka_env_step(t, profile=t == "AllegroKukaReorientation")
        kuka_launches[t]["epochs"] = train_epochs(t, KUKA_WIDTH[t], profile=False)
    lap(60)
    # 61. train.main task=AllegroKukaReorientation and task=AllegroKukaTwoArms (the resolver) at 8,192 envs:
    # train, restore bit-equal
    for t, name_ in (("AllegroKukaReorientation", "AllegroKukaReorientation"),
                     ("AllegroKukaTwoArmsReorientation", "AllegroKukaTwoArms")):
        kuka_launches[t]["train_main"] = train_main_at_width(name_, *KUKA_WIDTH[t][:2], resume=False, play=False)
    lap(61)
    # 62. the saveStates bank: written by train.main, read back by loadInitialStates resets
    kuka_launches["AllegroKukaReorientation"]["state_bank"] = kuka_state_bank()
    lap(62)
    # 63. both kernels timed at 8,192 envs
    kuka_t = {t: time_kuka(t, name) for t in KUKA_WIDTH}
    lap(63)
    # 64. DeXtreme against its plain versions at N=1003, on contact states with leaves drawn through ADR (each
    # physics parameter pinned at both edges in some envs): row 1ah (the ADR yaml) for HAND_STEPS env steps, ManualDR's
    # leaves (row 1ah') for one
    dex_err = {"AllegroHandDextremeADR": compare_hand("AllegroHandDextremeADR"),
               "AllegroHandDextremeManualDR": compare_hand("AllegroHandDextremeManualDR", steps=1)}
    lap(64)
    # 65. env-steps/s (ADR's device ops and busy share per env step); one PPO epoch after a warm-up at the yaml's
    # width
    dex_launches = {t: {} for t in DEX_WIDTH}
    for t in DEX_WIDTH:
        dextreme_env_step(t, profile=t == "AllegroHandDextremeADR")
        dex_launches[t]["epochs"] = train_epochs(t, DEX_WIDTH[t], profile=False)
    lap(65)
    # 66. a forced ADR run: nats and the ranges move on the card
    dex_launches["AllegroHandDextremeADR"]["forced_adr"] = forced_adr_run()
    lap(66)
    # 67. train.main for both at 8,192 envs: train, restore bit-equal (ADR's state under its gate); ADR's resume
    # and play
    for t in DEX_WIDTH:
        adr = t == "AllegroHandDextremeADR"
        dex_launches[t]["train_main"] = train_main_at_width(t, *DEX_WIDTH[t][:2], overrides=(ADR_GATE,), resume=adr,
                                                            play=adr)
    lap(67)
    # 68. both kernels timed at 8,192 envs
    dex_t = {t: time_dextreme(t, name) for t in DEX_WIDTH}
    lap(68)
    # 69. make() on the card: the env of Ant's yaml steps once through the kernel
    ant_launches_make = make_on_card()
    lap(69)
    # 70. PBT: two members of one Ant population at 4096 envs side by side on the card (one member alone first)
    torch.cuda.empty_cache()
    pbt = pbt_population()
    lap(70)
    # 71. HumanoidAMPHands: row 1u's build, hands on the ground allowed; train.main for one epoch, restore bit-equal
    amp_launches["hands_ground"] = hands_on_ground()
    amp_launches["hands_train_main"] = hands_train_main()
    lap(71)
    # 72. two ranks on the one card (gloo): train.main under torchrun, then Ant at 4,096 envs (2,048 each)
    # against one process; 73. local_shuffle on Ant, the LSTM recipe; 74. ADR over the ranks (one process of
    # ranks for 72-74), then one NCCL rank
    dp = data_parallel(smi, sizes, dp_started)
    dp_dir.cleanup()
    lap(73)
    nccl_launches = nccl_one_rank(smi)
    lap(74)
    # 75. FactoryTaskGears on the kernel route (row 1ai), 76. on the eager engine, 77. the other eager cases
    t75 = time.perf_counter()
    gears_err, gears_states = compare_gears(smi)
    gears_t, gears_launches = gears_kernel_path(smi, gears_states)
    lap(75)
    t76 = time.perf_counter()
    gears_eager_out = gears_eager(smi, gears_states)
    lap(76)
    t77 = time.perf_counter()
    eager_secs = other_eager_cases(smi)
    lap(77)
    t_end = time.perf_counter()
    print(f"steps 75-77: {t76 - t75:.1f} s, {t77 - t76:.1f} s, {t_end - t77:.1f} s, {t_end - t75:.1f} s together "
          f"({smi})")

    if any(n <= 0 for n in (train_launches, ant_launches_make, cart_launches, gears_launches,
                            *new_launches.values(), *dyn_launches.values(),
                            dp["launches"], dp["launches_lstm"], dp["launches_adr"], nccl_launches,
                            *anymal_launches.values(), *sdf_launches.values(), *humanoid_launches.values(),
                            *recipe_launches.values(), lstm_launches, *amp_launches.values(),
                            *(n for d in franka_launches.values() for n in d.values()),
                            *(n for d in nutbolt_launches.values() for n in d.values()),
                            *(n for d in industreal_launches.values() for n in d.values()),
                            *(n for d in hand_launches.values() for n in d.values()),
                            *(n for d in kuka_launches.values() for n in d.values()),
                            *(n for d in dex_launches.values() for n in d.values()))) \
            or set(dyn_launches) != set(DYN_CASES) or set(anymal_launches) != set(ANYMAL_CASES):
        raise AssertionError("a kernel of the main path was never launched")
    source = "isaacgymenvs_tpu_torch/engine/csrc/fused_step.cu"
    replaces = "isaacgymenvs_tpu/engine/fused.py:1834"
    names = {"Ingenuity": "fused_step_ingenuity", "Quadcopter": "fused_step_quadcopter_qt",
             "BallBalance": "fused_step_ballbalance_k4_qt", "Example": "fused_step_example_k4"}
    anymal_names = {"Anymal": "fused_step_anymal_qt", "AnymalTerrain": "fused_step_anymal_terrain_k5_k6_qt_dyn",
                    "AnymalTerrain-plane": "fused_step_anymal_plane_k5_qt_dyn"}
    sdf_names = {"Insertion": "fused_step_insertion_k5_k6sdf_qt", "Ball": "fused_step_ball_k6sdf"}
    franka_names = {"FrankaCubeStack": "fused_step_franka_cube_stack_k4_k5_qt",
                    "FrankaCabinet": "fused_step_franka_cabinet_k4mesh_k5_qt"}
    nutbolt_names = {t: f"fused_step_nut_bolt_{t[17:].lower()}_k5_k6sdf2_qt" for t in NUTBOLT_WIDTH}
    industreal_names = {"IndustRealTaskPegsInsert": "fused_step_industreal_pegs_k5_k6sdf2_qt",
                        "IndustRealTaskGearsInsert": "fused_step_industreal_gears_k5_k6sdf3_qt"}
    kuka_names = {"AllegroKukaReorientation": "fused_step_allegro_kuka_k4_qt",
                  "AllegroKukaTwoArmsReorientation": "fused_step_allegro_kuka_two_arms_k4_qt"}
    dex_names = {"AllegroHandDextremeADR": "fused_step_dextreme_adr_k4_k5_qt_dyn",
                 "AllegroHandDextremeManualDR": "fused_step_dextreme_manual_dr_k4_k5_qt_dyn"}
    hand_names = {"Trifinger": "fused_step_trifinger_k4_dyn", "ShadowHand": "fused_step_shadow_hand_k4_k5_qt_tendons",
                  "AllegroHand": "fused_step_allegro_hand_k4_k5_qt"}
    print(json.dumps({"kernels": [
        {"name": "fused_step", "route": "cuda", "source": source, "replaces": replaces,
         "launches": train_launches, "launches_rollout": launches, "launches_sac": recipe_launches["AntSAC"],
         "launches_make": ant_launches_make, "pbt_restarts": len(pbt["restarts"]),
         "launches_multi_rank": dp["launches"], "launches_nccl": nccl_launches,
         "two_rank_epoch_s": dp["two_rank_epoch_s"], "one_process_epoch_s": dp["one_process_epoch_s"],
         "pbt_member_epoch_s": pbt["member_median"], "pbt_alone_epoch_s": pbt["alone_median"], "max_abs_err": max_err,
         **ant_t, "library_ms": None, "num_envs": NUM_ENVS},
        {"name": "fused_step_nc0", "route": "cuda", "source": source, "replaces": replaces,
         "launches": cart_launches, "max_abs_err": max_err0,
         **cart_t[CARTPOLE_ENVS], "library_ms": None, "num_envs": CARTPOLE_ENVS,
         **{f"{k}_{NUM_ENVS}": v for k, v in cart_t[NUM_ENVS].items() if k != "bound_by"}},
        *({"name": names[t], "route": "cuda", "source": source, "replaces": replaces,
           "launches": new_launches[t], "max_abs_err": new_err[t], **new_t[t], "library_ms": None,
           "num_envs": NEW_CASES[t][2], "sizes": list(sizes[t])} for t in NEW_CASES),
        *({"name": "fused_step_" + k.lower().replace("+", "_"), "route": "cuda", "source": source,
           "replaces": replaces, "launches": dyn_launches[k], "max_abs_err": dyn_err[k], **dyn_t[k],
           "library_ms": None, "num_envs": DYN_CASES[k][2], "sizes": list(sizes[k]),
           "per_env_leaves": list(built[k][1])} for k in DYN_CASES),
        *({"name": anymal_names[k], "route": "cuda", "source": source, "replaces": replaces,
           "launches": anymal_launches[k], "max_abs_err": anymal_err[k], **anymal_t[k], "library_ms": None,
           "num_envs": ANYMAL_ENVS, "sizes": list(sizes[k]), "per_env_leaves": list(built[k][1]),
           **({"launches_lstm": lstm_launches, "launches_lstm_train_main": recipe_launches["AnymalTerrainPPO_LSTM"],
               "launches_lstm_multi_rank": dp["launches_lstm"]} if k == "AnymalTerrain" else {})}
          for k in ANYMAL_CASES),
        *({"name": sdf_names[k], "route": "cuda", "source": source, "replaces": replaces,
           "launches": sdf_launches[k], "max_abs_err": sdf_err[k], **sdf_t[k], "library_ms": None,
           "num_envs": INSERTION_ENVS if k == "Insertion" else NUM_ENVS, "sizes": list(sizes[k])}
          for k in sdf_names),
        {"name": "fused_step_humanoid", "route": "cuda", "source": source, "replaces": replaces,
         "launches": sum(humanoid_launches.values()), "launches_ppo": humanoid_launches["PPO"],
         "launches_sac": humanoid_launches["SAC"], "launches_train_main": recipe_launches["Humanoid"]
         + recipe_launches["HumanoidSAC"], "max_abs_err": humanoid_err, **humanoid_t, "library_ms": None,
         "num_envs": HUMANOID_ENVS, "sizes": list(sizes["Humanoid"])},
        {"name": "fused_step_humanoid_amp_k5_qt", "route": "cuda", "source": source, "replaces": replaces,
         "launches": sum(amp_launches.values()), **{f"launches_{k}": v for k, v in amp_launches.items()},
         "max_abs_err": amp_err, **amp_t, "library_ms": None, "num_envs": AMP_ENVS,
         "sizes": list(sizes["HumanoidAMP"])},
        *({"name": franka_names[t], "route": "cuda", "source": source, "replaces": replaces,
           "launches": sum(franka_launches[t].values()), **{f"launches_{k}": v for k, v in franka_launches[t].items()},
           "max_abs_err": franka_err[t], **franka_t[t], "library_ms": None, "num_envs": FRANKA_WIDTH[t][0],
           "sizes": list(sizes[t])} for t in FRANKA_WIDTH),
        *({"name": nutbolt_names[t], "route": "cuda", "source": source, "replaces": replaces,
           "launches": sum(nutbolt_launches[t].values()),
           **{f"launches_{k}": v for k, v in nutbolt_launches[t].items()},
           "max_abs_err": nutbolt_err[t], **nutbolt_t[t], "library_ms": None, "num_envs": NUTBOLT_ENVS,
           "sizes": list(sizes[t])} for t in NUTBOLT_WIDTH),
        *({"name": industreal_names[t], "route": "cuda", "source": source, "replaces": replaces,
           "launches": sum(industreal_launches[t].values()),
           **{f"launches_{k}": v for k, v in industreal_launches[t].items()},
           "max_abs_err": industreal_err[t], **industreal_t[t], "library_ms": None, "num_envs": INDUSTREAL_ENVS,
           "sizes": list(sizes[t])} for t in INDUSTREAL_WIDTH),
        *({"name": hand_names[t], "route": "cuda", "source": source, "replaces": replaces,
           "launches": sum(hand_launches[t].values()), **{f"launches_{k}": v for k, v in hand_launches[t].items()},
           "max_abs_err": max(hand_err[t], ff_err) if t == "ShadowHand" else hand_err[t], **hand_t[t],
           "library_ms": None, "num_envs": HAND_ENVS, "sizes": list(sizes[t]), "per_env_leaves": list(built[t][1]),
           **({"max_abs_err_openai_ff": ff_err, "sizes_openai_ff": list(sizes[HAND_FF]),
               "per_env_leaves_openai_ff": list(built[HAND_FF][1])} if t == "ShadowHand" else {})}
          for t in HAND_WIDTH),
        *({"name": kuka_names[t], "route": "cuda", "source": source, "replaces": replaces,
           "launches": sum(kuka_launches[t].values()), **{f"launches_{k}": v for k, v in kuka_launches[t].items()},
           "max_abs_err": max(kuka_err[t], kuka_err[KUKA_DR]) if t == "AllegroKukaReorientation" else kuka_err[t],
           **kuka_t[t], "library_ms": None, "num_envs": KUKA_ENVS, "sizes": list(sizes[t]),
           **({"max_abs_err_dr": kuka_err[KUKA_DR], "sizes_dr": list(sizes[KUKA_DR]),
               "per_env_leaves_dr": list(built[KUKA_DR][1])} if t == "AllegroKukaReorientation" else {})}
          for t in KUKA_WIDTH),
        *({"name": dex_names[t], "route": "cuda", "source": source, "replaces": replaces,
           "launches": sum(dex_launches[t].values()), **{f"launches_{k}": v for k, v in dex_launches[t].items()},
           "max_abs_err": dex_err[t], **dex_t[t], "library_ms": None, "num_envs": DEX_ENVS, "sizes": list(sizes[t]),
           "per_env_leaves": list(built[t][1]),
           **({"launches_multi_rank": dp["launches_adr"]} if t == "AllegroHandDextremeADR" else {})}
          for t in DEX_WIDTH),
        {"name": "fused_step_factory_gears_k5_k6sdf_qt", "route": "cuda", "source": source, "replaces": replaces,
         "launches": gears_launches, "max_abs_err": gears_err, **gears_t, "library_ms": None,
         "num_envs": GEARS_ENVS, "sizes": list(sizes[GEARS]),
         "eager_route": {**gears_eager_out, "other_cases_s": eager_secs}},
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(dp_rank(sys.argv[2]) if sys.argv[1:2] == ["--dp-rank"] else main())
